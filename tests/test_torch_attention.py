"""K3/K4 plain versions against the JAX package's Pallas kernels (interpret
mode) and against ``attend_xla``, on the same numpy inputs.

Tolerance: atol 2e-3 on the f32 output. Both sides use bf16 QK^T and PV
operands with f32 statistics; what differs is where P is rounded to bf16
(per 512-key block against the running max in the kernel, once against the
final max here) and the f32 reference's unrounded P. With V drawn in
[-1, 1], P's bf16 rounding moves the output by at most 2^-9 < 2e-3.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.ops.attention import (attend_xla as jattend_xla,
                                      flash_decode as jflash_decode,
                                      flash_prefill as jflash_prefill)

from neural_tpu_torch.convert.hf import init_random
from neural_tpu_torch.models import chatglm
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.runtime.kvcache import init_cache
from neural_tpu_torch.ops.attention import (
    attend, attend_xla, flash_decode, flash_decode_plain, flash_prefill,
    flash_prefill_plain)

B, HQ, HKV, DH = 1, 4, 2, 128
ATOL = 2e-3
SCALE = DH ** -0.5


def _inputs(T, S, seed):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32), jnp.bfloat16))
    # |v| <= 1 bounds the bf16 rounding of P in the output by 2^-9 < ATOL
    return (bf(rng.standard_normal((B, T, HQ, DH))),
            bf(rng.standard_normal((B, HKV, S, DH))),
            bf(rng.uniform(-1, 1, (B, HKV, S, DH))))


def _t(a):
    return torch.from_numpy(np.array(a.astype(np.float32))).bfloat16()


def _cfg():
    return JMC(n_heads=HQ, n_kv_heads=HKV, head_dim=DH), \
        ModelConfig(n_heads=HQ, n_kv_heads=HKV, head_dim=DH)


@pytest.mark.parametrize("fill", [1, 130, 512])
def test_k4_plain_matches_pallas_and_xla(fill):
    S = 512
    q, k, v = _inputs(1, S, seed=fill)
    lengths = np.array([fill], np.int32)
    ref = jflash_decode(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                        None, None, jnp.asarray(lengths), blk_s=512,
                        interpret=True)
    out = flash_decode_plain(_t(q[:, 0]), _t(k), _t(v),
                             torch.from_numpy(lengths), SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    jcfg, cfg = _cfg()
    pos = np.array([[fill - 1]], np.int32)
    xla = jattend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                      None, jnp.asarray(pos), jcfg)
    np.testing.assert_allclose(out.reshape(B, 1, -1).numpy(),
                               np.asarray(xla), atol=ATOL)
    # the dispatch takes K4 for T == 1 (the plain version on the CPU)
    disp = attend(_t(q), _t(k), _t(v), torch.from_numpy(pos).long(), cfg)
    assert torch.equal(disp, out.reshape(B, 1, -1))
    assert torch.equal(flash_decode(_t(q[:, 0]), _t(k), _t(v),
                                    torch.from_numpy(lengths), SCALE), out)


@pytest.mark.parametrize("start,T", [(0, 512), (0, 130), (200, 130)],
                         ids=["full", "fill130", "offset200"])
def test_k3_plain_matches_pallas_and_xla(start, T):
    S = 512
    q, k, v = _inputs(T, S, seed=T + start)
    starts = np.array([start], np.int32)
    Tp = -(-T // 128) * 128
    qp = np.pad(q, ((0, 0), (0, Tp - T), (0, 0), (0, 0)))
    ref = np.asarray(jflash_prefill(
        jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v),
        starts=jnp.asarray(starts), blk_t=128, blk_s=512,
        interpret=True))[:, :T]
    out = flash_prefill_plain(_t(q), _t(k), _t(v), torch.from_numpy(starts),
                              SCALE)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    jcfg, cfg = _cfg()
    pos = start + np.arange(T, dtype=np.int32)[None]
    xla = jattend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                      None, jnp.asarray(pos), jcfg)
    np.testing.assert_allclose(out.reshape(B, T, -1).numpy(),
                               np.asarray(xla), atol=ATOL)
    disp = attend(_t(q), _t(k), _t(v), torch.from_numpy(pos).long(), cfg)
    assert torch.equal(disp, out.reshape(B, T, -1))
    assert torch.equal(flash_prefill(_t(q), _t(k), _t(v),
                                     torch.from_numpy(starts), SCALE), out)


@pytest.mark.parametrize("T,fill", [(1, 300), (300, 300), (37, 300)],
                         ids=["decode", "prefill", "prefill_offset"])
def test_ragged_s_port_only(T, fill):
    """S=300 (no block multiple): port kernels' plain versions against the
    port's and the JAX package's f32 reference."""
    S = 300
    q, k, v = _inputs(T, S, seed=T)
    _, cfg = _cfg()
    pos = (fill - T + np.arange(T))[None]
    out = attend(_t(q), _t(k), _t(v), torch.from_numpy(pos).long(), cfg)
    ref = attend_xla(_t(q), _t(k), _t(v), torch.from_numpy(pos).long(), cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    jcfg, _ = _cfg()
    jref = jattend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                       None, jnp.asarray(pos.astype(np.int32)), jcfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=1e-5)


UNPORTED = {"learned_pos_emb": dict(learned_pos_emb=True),
            "parallel_residual": dict(parallel_residual=True),
            "qk_norm": dict(qk_norm=True),
            "moe": dict(n_experts=4, n_experts_active=2)}


@pytest.mark.parametrize("what", [*UNPORTED, "chatglm2"])
def test_unported_options_raise(what):
    """ALiBi and the GLM prefix mask are ported (``test_torch_alibi.py``),
    since the model-zoo slice learned positions, parallel residuals,
    qk-norm and ChatGLM-2/3's config (no ``position_encoding_2d``) too, and
    since the MoE slice the routed expert MLP: each builds and runs
    (``test_torch_zoo*.py`` and ``test_torch_moe*.py`` hold them against
    the JAX package)."""
    if what == "chatglm2":
        hf_cfg = types.SimpleNamespace(
            hidden_size=64, num_attention_heads=4, num_layers=2,
            padded_vocab_size=128, ffn_hidden_size=128,
            layernorm_epsilon=1e-5)
        cfg = chatglm.config_from_hf(hf_cfg)
        assert (cfg.arch, cfg.rope_style, cfg.rope_dim) == ("chatglm", "gptj",
                                                            8)
        return
    cfg = ModelConfig(vocab_size=64, hidden_size=64, n_layers=1, n_heads=2,
                      n_kv_heads=2, head_dim=32, intermediate_size=64,
                      **UNPORTED[what])
    model = init_random(cfg, quant=None, device="cpu")
    if what == "moe":
        assert model.layers[0].experts.w_up.weight.shape == (4, 64, 64)
    out = model(torch.tensor([[3, 4, 5]]), torch.zeros(1, dtype=torch.long),
                init_cache(cfg, 1, 8, device="cpu"))
    assert out.shape == (1, 3, 64) and torch.isfinite(out).all()
