"""The port's split table and mesh in one process (no process group): the
split of every at-rest layout exactly, against the JAX package's own
split where the layout is one both packages store, and the refusals.

- For each QTensor layout (the JAX storage layout of int1-8, nf4 and fp8,
  and the port's at-rest ones: native-pack nibbles and 2-bit fields, int8
  code planes, asym zero-points) and each split ("col" along N, "row" along
  packed K and the scale groups) over 2 and 4 ranks: the shards
  concatenated give back the whole QTensor, each shard dequantizes to its
  slice of the whole's dequantization, and splitting then converting to the
  at-rest layout equals converting then splitting. A storage-layout shard
  equals, field for field, the JAX ``device_put`` shard of the same
  QTensor on the virtual CPU mesh under the JAX spec.
- 64 q heads over 8 kv heads at tp = 8 (``tests/test_tp.py``'s GQA shape
  twin), as shard shapes only: ``shard_params`` for each of the 8 ranks.
- At tp = 1 in one process the sharded path is the single-device one,
  exactly (``model_step``, ``tp_generate``, ``Model.generate(mesh=...)``).
- What the split refuses, as the JAX package does or where it fails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from neural_tpu.core.dtypes import PRESETS as JPRESETS
from neural_tpu.core.qtensor import quantize as jquantize
from neural_tpu.parallel.ep import expert_capacity as jexpert_capacity
from neural_tpu.parallel.sharding import make_mesh as jmake_mesh

from neural_tpu_torch.convert.from_jax import (qtensor_from_numpy,
                                               tensor_to_numpy)
from neural_tpu_torch.convert.hf import init_random
from neural_tpu_torch.core.qtensor import dequantize, to_native
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.models.transformer import can_fuse_block
from neural_tpu_torch.parallel import (checksum, ep_param_specs,
                                       expert_capacity, make_mesh,
                                       param_specs, rank_generator,
                                       shard_model, shard_params, tp_generate)
from neural_tpu_torch.parallel.sharding import (Mesh, _shard_leaf,
                                                init_cache as pinit, lines,
                                                shard_cache)
from neural_tpu_torch.runtime.generate import batched_generate, model_step
from neural_tpu_torch.runtime.kvcache import init_cache
from neural_tpu_torch.runtime.sampling import SamplingParams
from test_torch_bridge import jax_array_to_numpy, jax_qtensor_to_numpy

K, N = 512, 64
STORED = ("q4_0", "q4_1", "q8_0", "int5", "int3", "int2", "int1", "nf4",
          "fp8")
# the port's at-rest layouts: native-pack (2-4 bit, sym and asym), int8
# code planes (5-8 bit)
AT_REST = ("q4_0", "q4_1", "q8_0", "int5", "int3", "int2")
SPLITS = {"col": {"planes": (None, "tp"), "scales": (None, "tp"),
                  "zeros": (None, "tp"), "perm": ()},
          "row": {"planes": ("tp", None), "scales": ("tp", None),
                  "zeros": ("tp", None), "perm": ()}}
_QT = {}


def fake_mesh(rank, **shape):
    """Rank ``rank``'s view of a mesh of ``shape`` (axis → size, in mesh
    order), without a process group: enough to split with."""
    return Mesh(shape, rank, {}, None, torch.device("cpu"))


def jax_qt(preset):
    if preset not in _QT:
        w = np.random.default_rng(7).standard_normal((K, N)) * 0.05
        _QT[preset] = jquantize(jnp.asarray(w, jnp.float32), JPRESETS[preset])
    return _QT[preset]


def port_qt(preset, at_rest):
    qt = qtensor_from_numpy(jax_qtensor_to_numpy(jax_qt(preset)), "cpu")
    return to_native(qt) if at_rest else qt


def _fields(qt):
    return [*qt.planes, qt.scales, qt.zeros]


def _shards(qt, split, n):
    return [_shard_leaf(qt, SPLITS[split], fake_mesh(r, tp=n), "w")
            for r in range(n)]


LAYOUTS = [(p, False) for p in STORED] + [(p, True) for p in AT_REST]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("split", ["col", "row"])
@pytest.mark.parametrize("preset,at_rest", LAYOUTS,
                         ids=[f"{p}-{'rest' if r else 'stored'}"
                              for p, r in LAYOUTS])
def test_split_round_trip_exact(preset, at_rest, split, n):
    qt = port_qt(preset, at_rest)
    shards = _shards(qt, split, n)
    dim = -1 if split == "col" else -2
    for whole, parts in zip(_fields(qt), zip(*map(_fields, shards))):
        if whole is None:
            assert all(p is None for p in parts)
            continue
        assert torch.equal(torch.cat(parts, dim), whole)
        assert all(p.is_contiguous() and p.untyped_storage().data_ptr() !=
                   whole.untyped_storage().data_ptr() for p in parts)
    full = dequantize(qt)
    for r, s in enumerate(shards):
        assert s.cfg == qt.cfg
        want = full.chunk(n, dim=1 if split == "col" else 0)[r]
        assert torch.equal(dequantize(s), want)
    if not at_rest:
        # splitting then converting equals converting then splitting
        for a, b in zip(map(to_native, shards), _shards(to_native(qt),
                                                        split, n)):
            for fa, fb in zip(_fields(a), _fields(b)):
                assert (fa is None and fb is None) or torch.equal(fa, fb)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("split", ["col", "row"])
@pytest.mark.parametrize("preset", STORED)
def test_split_equals_the_jax_shards(preset, split, n):
    """The port's shard of a stored-layout QTensor is the JAX ``device_put``
    shard of its fields under the JAX spec (``_qtensor_spec``), rank r on
    device r of a (dp=1, tp=n) mesh."""
    jqt = jax_qt(preset)
    mesh = jmake_mesh(dp=1, tp=n)
    spec = P(None, "tp") if split == "col" else P("tp", None)
    dim = 1 if split == "col" else 0
    ports = _shards(port_qt(preset, False), split, n)
    fields = [(jp, [p.planes[i] for p in ports])
              for i, jp in enumerate(jqt.planes)]
    fields.append((jqt.scales, [p.scales for p in ports]))
    if jqt.zeros is not None:
        fields.append((jqt.zeros, [p.zeros for p in ports]))
    for jfield, got in fields:
        arr = jax.device_put(jfield, NamedSharding(mesh, spec))
        js = sorted(arr.addressable_shards,
                    key=lambda s: s.index[dim].start or 0)
        assert len(js) == n
        for r, sh in enumerate(js):
            assert np.array_equal(tensor_to_numpy(got[r]),
                                  jax_array_to_numpy(sh.data)), r


def test_bias_and_tensor_splits():
    """An unquantized [K, N] weight splits like a QTensor's fields; a "col"
    product's bias ("col_b") along N; a replicated leaf stays whole."""
    w = torch.randn(16, 8)
    b = torch.randn(8)
    lp = {"wq": w, "bq": b, "wo": w.T.contiguous(), "bo": b,
          "attn_norm_w": b}
    spec = param_specs({"layers": [lp]}, None)["layers"][0]
    assert spec == {"wq": (None, "tp"), "bq": ("tp",), "wo": ("tp", None),
                    "bo": (), "attn_norm_w": ()}
    parts = [{k: _shard_leaf(v, spec[k], fake_mesh(r, tp=2), k)
              for k, v in lp.items()} for r in range(2)]
    assert torch.equal(torch.cat([p["wq"] for p in parts], 1), w)
    assert torch.equal(torch.cat([p["bq"] for p in parts]), b)
    assert torch.equal(torch.cat([p["wo"] for p in parts], 0), lp["wo"])
    assert all(torch.equal(p["bo"], b) for p in parts)


def _tiny(**kw):
    base = dict(arch="llama", vocab_size=256, hidden_size=128, n_layers=2,
                n_heads=8, n_kv_heads=4, head_dim=16, intermediate_size=256,
                max_seq_len=64)
    base.update(kw)
    return ModelConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny()
    return cfg, init_random(cfg, seed=0, quant="q4_0", device="cpu")


def test_tp8_70b_shape_gqa():
    """64 q heads over 8 kv heads at tp = 8: each rank one kv head (Dh
    columns), 8 q heads, 1/8 of the FFN; w_down's packed K rows and scale
    groups split 8 ways; the shards of each rank together are the whole."""
    cfg = _tiny(n_heads=64, n_kv_heads=8, head_dim=8, hidden_size=512,
                intermediate_size=1024, vocab_size=512, n_layers=1)
    model = init_random(cfg, seed=1, quant="q4_0", device="cpu")
    whole = model.param_dict()["layers"][0]
    ranks = [shard_params(model, cfg, fake_mesh(r, dp=1, tp=8))
             for r in range(8)]
    for r, sp in enumerate(ranks):
        lp = sp["layers"][0]
        assert lp["wq"].N == 64 * 8 // 8
        assert lp["wk"].N == lp["wv"].N == 8          # one kv head a rank
        assert lp["w_up"].N == whole["w_up"].N // 8
        assert lp["wk"].scales.shape[-1] == 8
        assert lp["w_down"].planes[0].shape[-2] == \
            whole["w_down"].planes[0].shape[-2] // 8
        assert lp["w_down"].scales.shape[-2] == \
            whole["w_down"].scales.shape[-2] // 8
        assert sp["lm_head"].N == 512 // 8
        assert torch.equal(sp["embed"], model.embed)
    for name, dim in (("wk", -1), ("w_down", -2)):
        assert torch.equal(torch.cat([sp["layers"][0][name].planes[0]
                                      for sp in ranks], dim),
                           whole[name].planes[0])


def test_tp1_sharded_path_is_the_single_device_path(tiny):
    """At tp = 1 in one process (no process group) the sharded model, its
    cache and ``tp_generate`` give exactly what one device gives."""
    cfg, model = tiny
    mesh = make_mesh(device="cpu")
    sm = shard_model(model, cfg, mesh)
    tok = torch.tensor([[5, 9, 2, 7, 33, 1, 8, 20]] * 2)
    st = torch.zeros(2, dtype=torch.long)
    a = model_step(model, tok, st, init_cache(cfg, 2, 32, device="cpu"))
    b = model_step(sm, tok, st, pinit(cfg, mesh, 2, 32))
    assert torch.equal(a, b)
    rows = [[3, 14, 15, 9], [7, 1, 2], [11, 6, 8, 2, 4]]
    for sp in (SamplingParams(greedy=True),
               SamplingParams(temperature=0.8, top_k=30)):
        assert tp_generate(model, cfg, mesh, rows, sp, max_new_tokens=5,
                           seed=3) == batched_generate(
            model, cfg, rows, sp, max_new_tokens=5, seed=3)
    from neural_tpu_torch.api import Model
    m = Model().init_params(model, cfg)
    assert m.generate(rows, max_new_tokens=4, mesh=mesh) == \
        m.generate(rows, max_new_tokens=4)


def test_mesh_shards_follow_new_params(tiny):
    """``Model.generate(mesh=...)`` keeps its shards with the mesh and the
    params they came from: after ``init_params`` with other weights (the
    old ones freed) and on a new mesh it shards again, and gives what one
    device gives with the new weights."""
    import gc

    from neural_tpu_torch.api import Model
    cfg, _ = tiny
    rows = [[3, 14, 15, 9], [7, 1, 2]]
    m = Model().init_params(init_random(cfg, seed=5, quant="q4_0",
                                        device="cpu"), cfg)
    mesh = make_mesh(device="cpu")
    m.generate(rows, max_new_tokens=4, mesh=mesh)
    for _ in range(2):
        m.init_params(init_random(cfg, seed=6, quant="q4_0", device="cpu"),
                      cfg)
        gc.collect()
        assert m.generate(rows, max_new_tokens=4, mesh=mesh) == \
            m.generate(rows, max_new_tokens=4)
        mesh = make_mesh(device="cpu")


def test_cache_split_by_rows_and_heads(tiny):
    """A whole cache's dp rows and tp kv heads (int8 scales with them) are
    what ``init_cache`` makes a rank, and the shards are the whole."""
    cfg, _ = tiny
    full = init_cache(cfg, 4, 16, torch.int8, device="cpu")
    for t in (full.k, full.v, full.k_scale, full.v_scale):
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    parts = [shard_cache(full, fake_mesh(r, dp=2, tp=2)) for r in range(4)]
    local = pinit(cfg, fake_mesh(0, dp=2, tp=2), 4, 16, torch.int8)
    assert local.k.shape == parts[0].k.shape == (2, 2, 2, 16, 16)
    assert local.k_scale.shape == parts[0].k_scale.shape == (2, 2, 2, 16)
    for name in ("k", "v", "k_scale", "v_scale"):
        rows = [torch.cat([getattr(parts[2 * d + t], name) for t in (0, 1)],
                          2) for d in (0, 1)]
        assert torch.equal(torch.cat(rows, 1), getattr(full, name))


def test_mesh_layout_without_a_process_group():
    """Rank r sits at the row-major coordinates of r, "tp" last, so
    consecutive ranks share a tp group; every axis's lines of ranks."""
    m = fake_mesh(5, dp=2, ep=2, tp=2)
    assert m.coords == {"dp": 1, "ep": 0, "tp": 1}
    got = lines({"dp": 2, "ep": 2, "tp": 2})
    assert got["tp"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert got["ep"] == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert got["dp"] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    one = make_mesh(device="cpu")
    x = torch.ones(3)
    assert one.psum(x) is x and one.all_gather(x) is x
    assert one.collective_free_step
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(tp=2, device="cpu")


def test_fusion_and_capture_decline_under_tp(tiny):
    """The fused decode path declines at tp > 1 (a residual inside a
    row-split kernel would be summed tp times), and a step with a
    collective is not captured; a dp-only mesh keeps both."""
    cfg, model = tiny
    x = torch.zeros(1, 1, cfg.hidden_size)
    assert can_fuse_block(x, cfg, "interpret", 1)
    assert not can_fuse_block(x, cfg, "interpret", 2)
    sm = shard_model(model, cfg, make_mesh(device="cpu"))
    assert sm.capturable
    sm.mesh = fake_mesh(0, dp=1, tp=2)
    assert not sm.capturable
    sm.mesh = fake_mesh(0, dp=2, tp=1)
    assert sm.capturable


def test_alibi_slopes_follow_the_rank_heads():
    slopes = torch.arange(8, dtype=torch.float32)
    params = {"layers": [], "alibi_slopes": slopes, "embed": slopes}
    spec = param_specs(params, None)
    parts = [_shard_leaf(slopes, spec["alibi_slopes"], fake_mesh(r, tp=2),
                         "alibi") for r in range(2)]
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert spec["embed"] == ()


def test_ep_specs():
    """Every expert leaf's E dim over "ep"; ``tp=False`` drops every tp
    split, the attention's too."""
    cfg = _tiny(arch="mixtral", n_experts=4, n_experts_active=2,
                intermediate_size=128, n_layers=1)
    model = init_random(cfg, seed=2, quant="q4_0", device="cpu")
    spec = ep_param_specs(model, cfg)["layers"][0]
    assert spec["experts"]["w_up"]["planes"] == ("ep", None, "tp")
    assert spec["experts"]["w_down"]["scales"] == ("ep", "tp", None)
    assert spec["router"] == ()
    flat = ep_param_specs(model, cfg, tp=False)["layers"][0]
    assert flat["experts"]["w_up"]["planes"] == ("ep", None, None)
    assert flat["wq"]["planes"] == (None, None)
    sp = shard_params(model, cfg, fake_mesh(1, dp=1, ep=2, tp=1),
                      ep_param_specs(model, cfg))
    ex = sp["layers"][0]["experts"]["w_up"]
    whole = model.layers[0].experts.w_up.qt
    assert torch.equal(ex.planes[0], whole.planes[0][2:])


@pytest.mark.parametrize("args", [(16, 4, 2, 4.0), (1, 8, 2, 8.0),
                                  (1975, 8, 2, 8.0), (32, 4, 1, 1.0),
                                  (7, 4, 2, 2.0)])
def test_expert_capacity_is_the_reference(args):
    assert expert_capacity(*args) == jexpert_capacity(*args)


def test_rank_generator_streams():
    """dp = 1: the single-device stream of ``seed`` on every rank; dp > 1:
    one stream a dp rank, the same across its tp ranks."""
    draw = lambda g: torch.rand(4, generator=g).tolist()
    base = draw(torch.Generator().manual_seed(9))
    assert draw(rank_generator(fake_mesh(1, dp=1, tp=2), 9, "cpu")) == base
    a = draw(rank_generator(fake_mesh(0, dp=2, tp=2), 9, "cpu"))
    b = draw(rank_generator(fake_mesh(1, dp=2, tp=2), 9, "cpu"))
    c = draw(rank_generator(fake_mesh(2, dp=2, tp=2), 9, "cpu"))
    assert a == base and a == b and c != a


def test_checksum_is_exact(tiny):
    cfg, model = tiny
    pd = model.param_dict()
    one = checksum(pd)
    assert one == checksum(model.param_dict())
    qt = pd["layers"][1]["wq"]
    flipped = qt.planes[0].clone()
    flipped[0, 0] ^= 1
    pd["layers"][1]["wq"] = dataclasses.replace(qt, planes=(flipped,))
    assert checksum(pd) != one


def _refuse(params, cfg, mesh, match, exc=ValueError):
    with pytest.raises(exc, match=match):
        shard_params(params, cfg, mesh)


def test_split_refusals(tiny):
    """Heads or kv heads that tp does not divide; a K split that cuts a
    scale group (and a per-channel weight's one group); an act-order
    weight under a K split, where the JAX TP step fails (ROADMAP C, the
    reference is at fault); the fused names; a vocabulary tp does not
    divide; experts ep does not divide; expert biases under tp."""
    cfg, model = tiny
    pd = model.param_dict()
    _refuse(pd, dataclasses.replace(cfg, n_heads=6), fake_mesh(0, tp=4),
            "q heads")
    _refuse(pd, cfg, fake_mesh(0, tp=8), "q heads")
    qt = pd["layers"][0]["wo"]
    perm = dataclasses.replace(qt, perm=torch.randperm(qt.K))
    one = {"layers": [{"wo": perm}]}
    _refuse(one, cfg, fake_mesh(0, tp=2), "act-order")
    # a col split keeps the perm whole
    ok = shard_params({"layers": [{"wq": perm}]}, cfg, fake_mesh(1, tp=2))
    assert torch.equal(ok["layers"][0]["wq"].perm, perm.perm)
    cut = {"layers": [{"wo": port_qt("fp8", False)}]}   # 4 groups of 128
    _refuse(cut, dataclasses.replace(cfg, n_heads=8, n_kv_heads=8),
            fake_mesh(0, tp=8), "cuts a scale group")
    pc = init_random(cfg, seed=0, quant="int8", device="cpu").param_dict()
    _refuse(pc, cfg, fake_mesh(0, tp=2), "cuts a scale group")
    fused = {"layers": [{"wqkv": qt}]}
    _refuse(fused, cfg, fake_mesh(0, tp=2), "fuse_layer_weights")
    from neural_tpu_torch.core.dtypes import PRESETS
    from neural_tpu_torch.core.qtensor import quantize
    head = to_native(quantize(torch.randn(128, 250) * 0.05,
                              PRESETS["q4_0"]))
    _refuse(dict(pd, lm_head=head), cfg, fake_mesh(0, tp=4),
            "does not split 4 ways")
    mcfg = _tiny(arch="mixtral", n_experts=4, n_experts_active=2,
                 intermediate_size=128, n_layers=1)
    _refuse({"layers": [{}]}, mcfg, fake_mesh(0, dp=1, ep=3, tp=1),
            "experts")
    biased = {"layers": [{"experts": {"b_down": torch.zeros(4, 128)}}]}
    _refuse(biased, mcfg, fake_mesh(0, tp=2), "expert biases",
            NotImplementedError)
