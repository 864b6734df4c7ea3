"""K1's fusion options and the fused decode path on the CPU: the port's
plain versions held against the JAX package's ``qmatmul_fused`` (the
Pallas kernel in interpret mode, as ``tests/test_fused_decode.py`` runs
it) and its ``forward`` under ``NTPU_FUSED_DECODE=interpret``, on the same
numpy inputs; weights quantized by JAX and carried over by the bridge.

Tolerances:
- the fused product, f32 output: rtol 1e-5 plus 1e-5·max|ref|, K1's
  plain-vs-Pallas tolerance (``tests/test_torch_k5.py``): the order of the
  sums differs. The prologue rounds its f32 result to bf16 on both sides;
  where the two packages' f32 prologues (XLA's and torch's mean, rsqrt,
  exp, erf, tanh) differ in the last bits, an element can round to the
  neighbouring bf16 value. Each such element widens the tolerance by what
  it moves the product: its bf16 step times the largest |w| of its row
  (the test counts them and states the widened bound);
- a bf16 output (the res epilogue): one bf16 rounding of the same f32
  sums, 2^-8·max|ref| on top;
- the models: 3e-2·max|logit|, the port's model-level tolerance against
  the JAX package (``test_torch_model.py``); greedy ids equal wherever
  JAX's top-2 margin exceeds twice the step's largest logit difference.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.api import Model as JModel  # noqa: E402
from neural_tpu.core.dtypes import QuantConfig as JQC  # noqa: E402
from neural_tpu.core.qtensor import (quantize as jquantize,  # noqa: E402
                                     to_native as jto_native,
                                     to_native_packed as jto_native_packed)
from neural_tpu.models.transformer import forward as jforward  # noqa: E402
from neural_tpu.ops.norms import rms_norm as jrms_norm  # noqa: E402
from neural_tpu.ops.qmatmul import qmatmul_fused as jqmatmul_fused  # noqa
from neural_tpu.runtime.generate import \
    params_to_native as jparams_to_native  # noqa: E402
from neural_tpu.runtime.kvcache import init_cache as jinit_cache  # noqa

from neural_tpu_torch.convert.from_jax import (params_from_numpy,  # noqa
                                               qtensor_from_numpy)
from neural_tpu_torch.convert.hf import ARCH_MODULES  # noqa: E402
from neural_tpu_torch.ops import qmatmul as Q  # noqa: E402
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from test_torch_bridge import (jax_qtensor_to_numpy,  # noqa: E402
                               jax_tree_to_numpy)

K, N = 256, 128
# the sym layouts K1 reads at rest: native-pack nibbles, int2 fields, int8
# code planes
LAYOUTS = {"nibbles": (JQC(bits=4, group_size=32), jto_native_packed),
           "int2": (JQC(bits=2, group_size=32), jto_native_packed),
           "int8_codes": (JQC(bits=8, group_size=32), jto_native)}
# option → (norm offset or None, glu activation or None, res)
OPTIONS = {"rms": (0.0, None, False), "rms_offset1": (1.0, None, False),
           "glu_silu": (None, "silu", False),
           "glu_gelu": (None, "gelu", False),
           "glu_gelu_tanh": (None, "gelu_tanh", False),
           "glu_relu": (None, "relu", False), "res": (None, None, True),
           "rms_res": (0.0, None, True)}
EPS = 1e-5


def _weight(layout, K=K, N=N, asym=False, seed=0):
    jcfg, at_rest = LAYOUTS[layout]
    if asym:
        jcfg = dataclasses.replace(jcfg, sym=False)
    w = (np.random.default_rng(seed).standard_normal((K, N)) * 0.05
         ).astype(np.float32)
    jqt = at_rest(jquantize(jnp.asarray(w), jcfg))
    return jqt, qtensor_from_numpy(jax_qtensor_to_numpy(jqt), "cpu")


def _bf16(a):
    """numpy f32 values rounded to bf16, as a (jax, torch) pair."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _jax_prologue(x, nw, offset, g, u, act):
    """The JAX kernel's prologue composed of JAX ops: act(g)·u in f32,
    rounded to bf16 (``_qmm4_kernel`` :673-689), then ``rms_norm``."""
    if act is not None:
        gf, uf = g.astype(jnp.float32), u.astype(jnp.float32)
        fn = {"silu": lambda v: v * jax.nn.sigmoid(v),
              "gelu": lambda v: jax.nn.gelu(v, approximate=False),
              "gelu_tanh": lambda v: jax.nn.gelu(v, approximate=True),
              "relu": lambda v: jnp.maximum(v, 0.0)}[act]
        x = (fn(gf) * uf).astype(jnp.bfloat16)
    if nw is not None:
        x = jrms_norm(x, nw, EPS, offset)
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fused_plain_matches_pallas_interpret(layout, option, M):
    offset, act, with_res = OPTIONS[option]
    jqt, qt = _weight(layout)
    rng = np.random.default_rng(M * 31 + len(option))
    xj, xt = _bf16(rng.standard_normal((M, K)) * 2)
    uj, ut = _bf16(rng.standard_normal((M, K)))
    nwj, nwt = _bf16(1 + 0.5 * rng.standard_normal(K))
    rj, rt = _bf16(rng.standard_normal((M, N)))
    odt = (jnp.bfloat16, torch.bfloat16) if with_res else \
        (jnp.float32, torch.float32)
    norm = None if offset is None else (nwt, EPS, offset)
    jnorm = None if offset is None else (nwj, EPS, offset)
    jx = (xj, uj) if act else xj
    ref = jqmatmul_fused(jx, jqt, out_dtype=odt[0], norm=jnorm, glu=act,
                         res=rj if with_res else None, interpret=True)
    args = (qt.planes[0], qt.scales, qt.group_size, qt.cfg.bits, odt[1])
    fuse = dict(norm=norm, u=ut if act else None, act=act,
                res=rt if with_res else None)
    out = Q.qmm_native_fused_plain(xt, *args, **fuse)
    # the wrapper and the dispatch take the plain version on the CPU
    assert torch.equal(Q.qmm_native_fused(xt, *args, **fuse), out)
    via = Q.qmatmul_fused((xt, ut) if act else xt, qt, odt[1], norm=norm,
                          glu=act, res=rt if with_res else None)
    assert torch.equal(via, out)

    # the prologues, and what the elements that round apart can move
    h = Q.fused_input_plain(xt, norm, ut if act else None, act).float()
    hj = _jax_prologue(xj, nwj if offset is not None else None, offset,
                       xj, uj, act)
    moved = np.abs(h.numpy() - hj)
    wmax = Q.native_codes(qt.planes[0], qt.cfg.bits).abs().float() \
        .reshape(K // qt.group_size, qt.group_size, N).amax(dim=(1, 2)) \
        * qt.scales.float().amax(dim=1)
    widen = float((torch.from_numpy(moved).reshape(M, -1, qt.group_size)
                   .sum(dim=2) * wmax[None]).sum(dim=1).max())
    # only exact and tanh GELU's f32 values (XLA's erf and tanh against
    # torch's, which differ most where 1 + erf cancels) round apart, in
    # under 2% of the elements and by less than a bf16 step of max|h|
    assert moved.max() <= 2 ** -8 * np.abs(hj).max(), option
    assert (moved > 0).mean() < 0.02, (option, int((moved > 0).sum()))
    assert act in ("gelu", "gelu_tanh") or not moved.any(), option
    ref = np.asarray(ref.astype(jnp.float32))
    scale = np.abs(ref).max()
    tol = 1e-5 * scale + widen + (2 ** -8 * scale if with_res else 0.0)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-5, atol=tol)


def _jax_none(x, jqt, **kw):
    return jqmatmul_fused(x, jqt, interpret=True, **kw) is None


@pytest.mark.parametrize("case", ["eligible", "asym", "perm", "M17",
                                  "N192", "glu_M17"])
def test_none_exactly_where_jax_is_none(case):
    """The port's ``qmatmul_fused`` declines (returns None) on the inputs
    JAX's declines, and takes the ones JAX's takes."""
    Nw = 192 if case == "N192" else N
    jqt, qt = _weight("nibbles", N=Nw, asym=case == "asym")
    if case == "perm":
        perm = np.random.default_rng(1).permutation(K).astype(np.int32)
        jqt = dataclasses.replace(jqt, perm=jnp.asarray(perm))
        qt = dataclasses.replace(qt, perm=torch.from_numpy(perm).long())
    M = 17 if case.endswith("M17") else 4
    xj, xt = _bf16(np.random.default_rng(2).standard_normal((M, K)))
    if case.startswith("glu"):
        jx, px, kw = (xj, xj), (xt, xt), dict(glu="silu")
    else:
        nw = np.ones(K, np.float32)
        jx, px = xj, xt
        kw = dict(norm=(jnp.asarray(nw), EPS, 0.0))
    expect_none = case != "eligible"
    assert _jax_none(jx, jqt, **kw) == expect_none
    pkw = dict(kw)
    if "norm" in pkw:
        pkw["norm"] = (torch.from_numpy(nw), EPS, 0.0)
    assert (Q.qmatmul_fused(px, qt, torch.float32, **pkw) is None) \
        == expect_none


# ---------------------------------------------------------------------------
# the fused decode path of the model
# ---------------------------------------------------------------------------

VOCAB = 256
T_PROMPT, N_STEPS = 8, 3


def _hf(kind):
    """A tiny HF Llama or Gemma 1 (GQA, head dim 128, widths that are
    multiples of 128, so every product qualifies) with random norm weights:
    HF initialises them to ones (zeros for Gemma's 1 + w), which would hide
    the weight in the prologue."""
    t = transformers
    torch.manual_seed(0)
    common = dict(vocab_size=VOCAB, hidden_size=256, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=1,
                  intermediate_size=512, max_position_embeddings=512)
    if kind == "gemma":
        hf = t.GemmaForCausalLM(t.GemmaConfig(head_dim=128, **common))
    else:
        hf = t.LlamaForCausalLM(t.LlamaConfig(rms_norm_eps=1e-5, **common))
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.copy_(0.2 + 0.3 * torch.rand(p.shape))
    return hf.eval()


@pytest.fixture(scope="module", params=["llama", "gemma"])
def pair(request):
    """(JAX Model at q4_j with native-pack weights, the port's decoder on
    the bridged tree)."""
    hf = _hf(request.param)
    jm = JModel().init_from_hf_model(hf, "q4_j")
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    cfg = ARCH_MODULES[hf.config.model_type].config_from_hf(hf.config)
    return jm, params_from_numpy(jax_tree_to_numpy(jm.params), cfg, "cpu")


def _ids():
    return np.random.default_rng(5).integers(3, VOCAB, T_PROMPT).tolist()


@torch.inference_mode()
def _port_logits(model, ids, feed):
    """The prefill's logits (all T_PROMPT rows: B·T <= 16, so the prefill
    takes the fused path too) and one decode step per id of ``feed``."""
    cache = init_cache(model.cfg, 1, T_PROMPT + N_STEPS + 1, device="cpu")
    out = [model(torch.tensor([ids]), torch.zeros(1, dtype=torch.long),
                 cache)[0]]
    for s, tok in enumerate(feed):
        out.append(model(torch.tensor([[tok]]),
                         torch.tensor([T_PROMPT + s]), cache)[0, -1:])
    return [o.float().numpy() for o in out]


def _jax_greedy(jm, ids):
    """JAX's prefill logits and N_STEPS decode steps, each fed the argmax
    of the step before; returns (logits per step, the ids fed)."""
    cache = jinit_cache(jm.cfg, 1, T_PROMPT + N_STEPS + 1, jnp.bfloat16)
    logits, cache = jforward(jm.params, jnp.asarray([ids], jnp.int32),
                             jnp.zeros((1,), jnp.int32), cache, jm.cfg)
    out, feed = [np.asarray(logits[0], np.float32)], []
    for s in range(N_STEPS):
        feed.append(int(np.argmax(out[-1][-1])))
        logits, cache = jforward(jm.params,
                                 jnp.asarray([[feed[-1]]], jnp.int32),
                                 jnp.asarray([T_PROMPT + s], jnp.int32),
                                 cache, jm.cfg)
        out.append(np.asarray(logits[0, -1:], np.float32))
    return out, feed


def _fused_calls(monkeypatch):
    """Count the products that take the fused plain version."""
    calls = []
    plain = Q.qmm_native_fused_plain

    def counted(*a, **kw):
        calls.append(inspect.signature(plain).bind(*a, **kw).arguments)
        return plain(*a, **kw)
    monkeypatch.setattr(Q, "qmm_native_fused_plain", counted)
    return calls


def test_fused_model_without_glu_is_bit_equal_to_unfused(pair, monkeypatch):
    """On the CPU the fused path without GLU runs the unfused chain's own
    ops (``rms_norm``, K1's plain version, the bf16 add): equal logits, bit
    for bit, with every product of the 2-layer model and the lm_head on
    the fused route."""
    _, model = pair
    ids = _ids()
    feed = [7, 11, 13]
    monkeypatch.setenv("NTPU_FUSED_DECODE", "0")
    want = _port_logits(model, ids, feed)
    calls = _fused_calls(monkeypatch)
    monkeypatch.setenv("NTPU_FUSED_DECODE", "interpret")
    got = _port_logits(model, ids, feed)
    # 7 products a layer, 2 layers, the lm_head (Gemma's is tied: a torch
    # product), in each of the 4 forward calls
    per_call = 14 + (model.lm_head is not None)
    assert len(calls) == 4 * per_call
    assert sum(kw.get("norm") is not None for kw in calls) == 4 * (
        10 + (model.lm_head is not None))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # "1" is the card's switch: on the CPU it leaves the path unfused, as
    # the JAX package's does off the TPU
    monkeypatch.setenv("NTPU_FUSED_DECODE", "1")
    n = len(calls)
    _port_logits(model, ids, feed[:1])
    assert len(calls) == n


@pytest.mark.parametrize("case", ["nf4", "q4_j_bf16_up"])
def test_declined_products_keep_the_unfused_chain(case, monkeypatch):
    """A pre-norm rides the kernels only when the fused kernel takes every
    product behind it; otherwise the block computes the norm once and runs
    the unfused chain there. nf4 (a LUT format the fused kernel does not
    take): every block unfused, the graph's own norms as many as unfused
    (2 a layer and the final one, not one per product). Layer 0's w_up a
    bf16 weight: that layer's gate/up take the one unfused FFN norm, its
    q/k/v, wo and w_down and layer 1 stay fused. Logits bit-equal to the
    unfused run in both."""
    from neural_tpu_torch.convert.hf import build_param_dict
    from neural_tpu_torch.core.qtensor import dequantize
    from neural_tpu_torch.models import transformer as T
    from neural_tpu_torch.runtime.generate import params_to_native
    hf = _hf("llama")
    cfg = ARCH_MODULES["llama"].config_from_hf(hf.config)
    sd = {k: v.float().numpy() for k, v in hf.state_dict().items()}
    params = params_to_native(build_param_dict(
        sd, cfg, quant="nf4" if case == "nf4" else "q4_j", device="cpu"))
    if case == "q4_j_bf16_up":
        lp = params["layers"][0]
        lp["w_up"] = dequantize(lp["w_up"]).to(torch.bfloat16)
    model = T.Transformer(cfg, params)
    norms = []
    graph_norm = T.rms_norm
    monkeypatch.setattr(T, "rms_norm",
                        lambda *a, **kw: norms.append(1) or graph_norm(*a,
                                                                       **kw))
    ids, feed = _ids(), [7, 11, 13]
    monkeypatch.setenv("NTPU_FUSED_DECODE", "0")
    want = _port_logits(model, ids, feed)
    assert len(norms) == 4 * 5
    calls = _fused_calls(monkeypatch)
    norms.clear()
    monkeypatch.setenv("NTPU_FUSED_DECODE", "interpret")
    got = _port_logits(model, ids, feed)
    # per forward call: (graph norms, fused products)
    per_call = (5, 0) if case == "nf4" else (1, 5 + 7 + 1)
    assert (len(norms), len(calls)) == tuple(4 * n for n in per_call)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("glu", ["0", "1"])
def test_fused_model_matches_jax_fused(pair, glu, monkeypatch):
    """The port's fused model against JAX's ``forward`` with its fused
    Pallas kernels in interpret mode, both under ``NTPU_FUSED_DECODE=
    interpret`` (and ``NTPU_FUSE_GLU``): the prefill and N_STEPS decode
    steps fed JAX's greedy ids, logits within the model tolerance, the
    argmax equal wherever JAX's margin proves it."""
    jm, model = pair
    monkeypatch.setenv("NTPU_FUSED_DECODE", "interpret")
    monkeypatch.setenv("NTPU_FUSE_GLU", glu)
    ids = _ids()
    jl, feed = _jax_greedy(jm, ids)
    calls = _fused_calls(monkeypatch)
    pl = _port_logits(model, ids, feed)
    assert sum(kw.get("u") is not None for kw in calls) == \
        (2 * 4 if glu == "1" else 0)
    proven = 0
    for step, (p, j) in enumerate(zip(pl, jl)):
        scale = np.abs(j).max()
        err = np.abs(p - j).max()
        assert err <= 3e-2 * scale, (step, err, scale)
        row_p, row_j = p[-1], j[-1]
        top2 = np.sort(row_j)[-2:]
        if top2[1] - top2[0] > 2 * err:
            assert int(np.argmax(row_p)) == int(np.argmax(row_j)), step
            proven += 1
    assert proven >= 2, proven
