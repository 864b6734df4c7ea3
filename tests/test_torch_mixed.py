"""Mixed-bit weights in the port against the JAX package: the quant
registry (first-match rules, the two mixed presets, a registry whose rules
differ per layer), LoRA merged at load, and K2's plain version over the
weight layouts that are not int4 (native-pack int2 and int3, int8 code
planes of int6), sym and asym, against the Pallas kernel in interpret mode.

Tolerances:
- models: the tiny Llama of ``test_torch_formats.py`` quantized by both
  packages with the same registry; every tensor bit-equal through the
  bridge; logits 3e-2·max|logit| and greedy ids where JAX's margin proves
  them, that file's rule and reasons.
- K2 against ``_qmatmul_a8_pallas``: rtol 1e-5 + 1e-5·max|ref|, the same
  int8 codes and exact integer dots with the same f32 fold; for sym weights
  the TPU dispatch quantizes x inside the kernel, where jitted XLA division
  moves a few codes one step (ROADMAP.md section C): exactly the rows that
  hold such a code are left out, as ``test_torch_qmatmul.py`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu import native as jnative
from neural_tpu.api import Model as JModel
from neural_tpu.api import quant_config_from_args as jquant_config_from_args
from neural_tpu.convert import lora as JL
from neural_tpu.convert.quant_registry import (MIXED_PRESETS as JMIXED,
                                               QuantRegistry as JReg)
from neural_tpu.core.dtypes import QuantConfig as JQC
from neural_tpu.core.qtensor import (quantize as jquantize,
                                     to_native as jto_native,
                                     to_native_packed as jto_native_packed)
from neural_tpu.ops.qmatmul import qmatmul as jqmatmul
from neural_tpu.ops.qmatmul import quantize_act_i8 as jquantize_act_i8
from neural_tpu.runtime.generate import (model_step as jmodel_step,
                                         params_to_native as jparams_to_native,
                                         prefill_step as jprefill_step)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert import lora as PL
from neural_tpu_torch.convert.from_jax import (params_from_numpy,
                                               qtensor_from_numpy)
from neural_tpu_torch.convert.hf import init_random
from neural_tpu_torch.convert.quant_registry import (MIX_INT2_INT4,
                                                     MIXED_PRESETS,
                                                     QuantRegistry)
from neural_tpu_torch.core.dtypes import QuantConfig, quant_config_from_args
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.qmatmul import (_pick_a8, qmatmul, qmm_a8,
                                          qmm_a8_plain, route)
from neural_tpu_torch.runtime.generate import model_step, prefill_step
from neural_tpu_torch.runtime.kvcache import init_cache
from test_torch_bridge import jax_qtensor_to_numpy, jax_tree_to_numpy
from test_torch_model import REL_TOL, VOCAB, _jax_margins
from test_torch_qmatmul import _jit_in_kernel_codes


def test_resolve_first_match_wins():
    for R in (QuantRegistry, JReg):
        reg = R(rules=[("layers.0.*", "int8"), ("w_down", "q4_0"),
                       ("*", "int3")], default=None)
        assert reg.resolve("w_down", 0).bits == 8       # layer rule first
        assert reg.resolve("w_down", 2).bits == 4
        assert reg.resolve("wq", 1).bits == 3
        assert reg.resolve("lm_head") is not None       # "*" matches it
        assert R(rules=[("w_*", "q4_0")]).resolve("embed") is None


@pytest.mark.parametrize("name", ["mix_int2_int4", "mix_i2_ffn"])
def test_mixed_presets_equal_jax(name):
    """The preset name gives the registry, with the JAX package's rules."""
    reg, jreg = quant_config_from_args(name), jquant_config_from_args(name)
    assert reg is MIXED_PRESETS[name] and jreg is JMIXED[name]
    assert [(p, c and c.__dict__) for p, c in reg.rules] == \
        [(p, c and c.__dict__) for p, c in jreg.rules]
    assert reg.default.__dict__ == jreg.default.__dict__


def test_init_random_takes_a_registry():
    """The mixed preset's layout: each tensor quantized by its rule and at
    rest, the lm_head at int8 codes; generation runs."""
    cfg = ModelConfig(arch="llama", vocab_size=256, hidden_size=128,
                      n_layers=3, n_heads=8, n_kv_heads=4, head_dim=16,
                      intermediate_size=256, max_seq_len=64)
    m = init_random(cfg, quant=MIX_INT2_INT4, device="cpu")
    for blk in m.layers:
        assert blk.w_gate.cfg.bits == 2 and blk.w_gate.cfg.group_size == 16
        assert blk.w_up.cfg.bits == 2 and blk.w_gate.cfg.native_pack
        assert blk.w_down.cfg.bits == 4 and not blk.w_down.cfg.sym
        assert blk.wq.cfg.bits == 4 and blk.wq.cfg.sym
    assert m.lm_head.cfg.bits == 8
    assert m.lm_head.planes.dtype == torch.int8
    out = Model().init_params(m, cfg).generate([3, 5, 7], max_new_tokens=4,
                                               stop_at_eos=False)[0]
    assert len(out) == 7


def test_hetero_registry_layout():
    """Rules that differ per layer give each of the port's per-layer blocks
    its own configs (the JAX package's per-layer tuple layout); generation
    runs."""
    cfg = ModelConfig(arch="llama", vocab_size=256, hidden_size=128,
                      n_layers=3, n_heads=8, n_kv_heads=4, head_dim=16,
                      intermediate_size=256, max_seq_len=64)
    reg = QuantRegistry(rules=[("layers.0.w_up", "int8"),
                               ("layers.2.*", QuantConfig(bits=3,
                                                          group_size=32))],
                        default="q4_0")
    m = init_random(cfg, quant=reg, device="cpu")
    L = m.layers
    assert L[0].w_up.cfg.bits == 8 and L[1].w_up.cfg.bits == 4
    assert L[2].w_up.cfg.bits == 3 and L[2].wq.cfg.bits == 3
    assert L[0].wq.cfg.bits == 4 and L[0].w_up.planes.dtype == torch.int8
    out = Model().init_params(m, cfg).generate([3, 5], max_new_tokens=4,
                                               stop_at_eos=False)[0]
    assert len(out) == 6


REGISTRIES = ("mix_int2_int4", "mix_i2_ffn")
N_NEW, MIN_PROVEN = 8, 4
# the prompt's seed was checked to prove at least MIN_PROVEN steps for every
# registry, as test_torch_formats.py picks its own: with other prompts a
# legitimate parting of the ids at an unproven step can leave fewer (seed
# 303 proved 2 for mix_i2_ffn, its ids parting at step 3 where JAX's margin
# was below the bound)


@pytest.fixture(scope="module")
def hf():
    hc = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=256, intermediate_size=1000,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hc).eval()


@pytest.fixture(scope="module", params=REGISTRIES)
def pair(request, hf):
    with pytest.MonkeyPatch.context() as mp:
        # JAX's build_params quantizes through its optional C++ codec when
        # it is built, which rounds one tie of this int8 lm_head the other
        # way (-25.499998 → 102, not 103); the port mirrors the package's
        # own ``quantize``, which the codec stands in for
        mp.setattr(jnative, "available", lambda: False)
        jm = JModel().init_from_hf_model(hf, request.param)
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    pm = Model().init_from_hf_model(hf, request.param, device="cpu")
    return request.param, jm, pm


def test_registry_model_equals_jax(pair):
    """Every tensor of the port's model equals the bridged JAX tree's."""
    name, jm, pm = pair
    bridged = params_from_numpy(jax_tree_to_numpy(jm.params), pm.cfg, "cpu")
    a, b = pm.params.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    L = pm.params.layers
    if name == "mix_i2_ffn":
        assert L[0].w_gate.cfg.bits == 2 and L[0].wq.cfg.act_bits == 8


def check_against_jax(jm, pm, ids, n_new=N_NEW, min_proven=MIN_PROVEN):
    """Prefill logits and ``n_new`` decode steps fed JAX's ids within
    REL_TOL·max|logit|; ``Model.generate``'s greedy ids equal to JAX's at
    every step whose margin proves them, up to the first step where they
    part; at least ``min_proven`` proven."""
    T = len(ids)
    jnew = jm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False)[0][T:]
    pnew = pm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False)[0][T:]
    jc = jinit_cache(jm.cfg, 1, T + n_new)
    jl, jc = jprefill_step(jm.params, jnp.asarray([ids], jnp.int32),
                           jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    pc = init_cache(pm.cfg, 1, T + n_new, device="cpu")
    pl = prefill_step(pm.params, torch.tensor([ids]),
                      torch.zeros(1, dtype=torch.long), pc)

    def close(a, b):
        b = np.asarray(b, np.float32)[0, -1]
        a = np.asarray(a, np.float32)[0, -1]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=REL_TOL * np.abs(b).max())
        return float(np.abs(a - b).max())

    errs = [close(pl.numpy(), jl)]
    for s, tok in enumerate(jnew[:-1]):
        jl, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([T + s], jnp.int32), jc, jm.cfg)
        pl = model_step(pm.params, torch.tensor([[tok]]),
                        torch.tensor([T + s]), pc)
        errs.append(close(pl.numpy(), jl))
    proven = 0
    for i, ((m, _), e) in enumerate(zip(_jax_margins(jm, ids, jnew), errs)):
        if m > 2 * 1.1 * e:
            assert pnew[i] == jnew[i], (i, pnew, jnew, errs)
            proven += 1
        if pnew[i] != jnew[i]:
            break
    assert proven >= min_proven, (pnew, jnew, errs)


def test_registry_logits_and_greedy_ids_match_jax(pair):
    """A 300-token prompt: its prefill takes K2 where the rule has int8
    activations and K5 elsewhere, its decode K1 (and K5 for mix_int2_int4's
    group-16 int2)."""
    _, jm, pm = pair
    check_against_jax(jm, pm, np.random.default_rng(0).integers(
        3, VOCAB, 300).tolist())


def test_lora_merge_matches_jax_and_torch(hf):
    """``merge_lora`` gives JAX's merged tensor; the merged model (bf16
    projections) gives the logits of the HF model with the same weight
    surgery, within 3e-2·max."""
    rng = np.random.default_rng(0)
    r = 4
    A = rng.standard_normal((r, 256)).astype(np.float32) * 0.1
    B = rng.standard_normal((256, r)).astype(np.float32) * 0.1
    lora = {
        "base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight": A,
        "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight": B,
    }
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    target = "model.layers.0.self_attn.q_proj.weight"
    merged = PL.merge_lora(sd, lora, alpha=8.0)
    np.testing.assert_array_equal(merged[target],
                                  JL.merge_lora(sd, lora, alpha=8.0)[target])
    np.testing.assert_allclose(merged[target], sd[target] + 2.0 * (B @ A),
                               rtol=1e-5)
    params, cfg = PL.from_hf_model_with_lora(hf, lora, alpha=8.0, quant=None,
                                             device="cpu")
    toks = torch.tensor([[3, 5, 9, 2]])
    ours = params(toks, torch.zeros(1, dtype=torch.long),
                  init_cache(cfg, 1, 8, device="cpu"))[0].float()
    import copy
    m = copy.deepcopy(hf)
    with torch.no_grad():
        m.model.layers[0].self_attn.q_proj.weight += torch.tensor(
            2.0 * (B @ A))
        ref = m(toks).logits[0]
    torch.testing.assert_close(ours, ref, rtol=0,
                               atol=3e-2 * ref.abs().max().item())
    with pytest.raises(ValueError):
        PL.merge_lora({"w": np.zeros((2, 2), np.float32)},
                      {"junk": np.zeros(2)})


# ---------------------------------------------------------------------------
# K2 over int2 / int3 native-pack fields and int8 code planes
# ---------------------------------------------------------------------------

M2, K2, N2 = 256, 512, 256


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("bits", [2, 3, 6])
def test_k2_layouts_match_pallas_interpret(bits, sym):
    """K2's plain version over native-pack int2 / int3 and int8 code planes
    (int6), group 128, act_bits 8, against ``_qmm_a8_kernel`` in interpret
    mode (sym: x quantized in the kernel; asym: outside it); ``qmatmul``
    routes the product to K2 and gives the plain version's result."""
    rng = np.random.default_rng(bits + 10 * sym)
    w = (rng.standard_normal((K2, N2)) * 0.05).astype(np.float32)
    jqt = jquantize(jnp.asarray(w), JQC(bits=bits, group_size=128, sym=sym,
                                        act_bits=8))
    jqt = jto_native_packed(jqt) if bits <= 4 else jto_native(jqt)
    qt = qtensor_from_numpy(jax_qtensor_to_numpy(jqt), "cpu")
    assert qt.planes[0].dtype == (torch.uint8 if bits <= 4 else torch.int8)
    x = np.random.default_rng(11).standard_normal((M2, K2)) \
        .astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jqmatmul(xb, jqt, out_dtype=jnp.float32,
                              interpret=True))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    gd = _pick_a8(M2, K2, N2, qt)
    assert gd == 128 and route(M2, K2, N2, qt) == "K2"
    args = (qt.planes[0], qt.scales, qt.group_size, gd, torch.float32,
            qt.zeros, bits)
    out = qmm_a8_plain(xt, *args)
    ok = np.ones(M2, bool)
    if sym:
        flipped = (_jit_in_kernel_codes(xb, gd)
                   != np.asarray(jquantize_act_i8(xb, gd)[0])).any(axis=1)
        assert flipped.sum() < M2 // 8
        ok = ~flipped
    np.testing.assert_allclose(out.numpy()[ok], ref[ok], rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    assert torch.equal(qmm_a8(xt, *args), out)
    assert torch.equal(qmatmul(xt, qt, torch.float32), out)


def test_k2_layouts_route_by_preset():
    """What reaches K2's new branches: ``quant_config_from_args("int6",
    group_size=128)`` (int8 codes), an int2 or int3 config with act_bits 8
    (native-pack fields); ``"int2"`` and ``"int3"`` are presets at act_bits
    16 and take K5."""
    w = torch.randn(512, 256, generator=torch.Generator().manual_seed(0))
    from neural_tpu_torch.core.qtensor import quantize, to_native
    for cfg, want in ((quant_config_from_args("int6", group_size=128), "K2"),
                      (QuantConfig(bits=2, group_size=128, act_bits=8), "K2"),
                      (QuantConfig(bits=3, group_size=128, sym=False,
                                   act_bits=8), "K2"),
                      (quant_config_from_args("int2"), "K5"),
                      (quant_config_from_args("int3"), "K5")):
        qt = to_native(quantize(w, cfg))
        assert route(300, 512, 256, qt) == want, cfg
        assert qmatmul(torch.randn(300, 512), qt).shape == (300, 256)
