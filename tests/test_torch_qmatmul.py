"""K1/K2 plain versions and the port's qmatmul dispatch against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_qmatmul.py`` runs them.

Tolerances:
- K1 vs ``_qmm4_kernel`` (interpret): rtol 1e-5 plus 1e-5·max|ref| in f32 —
  both compute f32 group partials of the same integer codes times bf16
  scales; only the summation order differs.
- K2 vs ``_qmm_a8_kernel`` (interpret): the int8 activation codes and
  scales are EQUAL to ``quantize_act_i8``'s; outputs within rtol 1e-5 plus
  1e-5·max|ref| — in the in-kernel mode, on the rows whose codes XLA's
  jitted CPU division does not move (see the test).
- ``qmatmul`` at M=40 vs ``qmatmul_native`` (the JAX CPU path): the
  product now goes to K5, as the JAX dispatch sends it on the TPU (the
  test keeps the name it had when K1 took it). Both sides round x and
  the dequantized weight to bf16, the same values for sym int4 codes at
  rest; the 1e-2·max|ref| set when K1's f32 dequant took this product
  stays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.core.dtypes import PRESETS as JPRESETS
from neural_tpu.core.qtensor import (quantize as jquantize,
                                     to_native_packed as jto_native_packed)
from neural_tpu.ops import qmatmul as jqmatmul
from neural_tpu.ops.qmatmul import (matmul_a8_ref as jmatmul_a8_ref,
                                    qmatmul_native as jqmatmul_native,
                                    quantize_act_i8 as jquantize_act_i8)

from neural_tpu_torch.core.dtypes import PRESETS
from neural_tpu_torch.core.qtensor import quantize, to_native_packed
from neural_tpu_torch.ops.qmatmul import (
    _pick_a8, act_quant_i8, matmul_a8_ref, qmatmul, qmm_a8, qmm_a8_plain,
    qmm_native, qmm_native_plain, quantize_act_i8)
from test_torch_bridge import jax_qtensor_to_numpy
from neural_tpu_torch.convert.from_jax import qtensor_from_numpy


def _weights(K, N, seed, preset="q4_j"):
    """The same native-pack weight in both packages (JAX-quantized, carried
    over by the bridge)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jnpk = jto_native_packed(jquantize(jnp.asarray(w), JPRESETS[preset]))
    return jnpk, qtensor_from_numpy(jax_qtensor_to_numpy(jnpk), "cpu")


def _x(M, K, seed):
    x = np.random.default_rng(seed).standard_normal((M, K))
    return x.astype(np.float32)


def _jit_in_kernel_codes(xb, gd):
    """The codes of ``_qmm_a8_kernel``'s in-kernel quantization
    (ops/qmatmul.py:272-276) as XLA computes them under jit."""
    @jax.jit
    def codes(x):
        parts = []
        for j in range(x.shape[1] // gd):
            xg = x[:, j * gd:(j + 1) * gd].astype(jnp.float32)
            a = (jnp.max(jnp.abs(xg), axis=1, keepdims=True) + 1e-9) / 127.0
            parts.append(jnp.round(xg / a).astype(jnp.int8))
        return jnp.concatenate(parts, axis=1)
    return np.asarray(codes(xb))


def _close(out, ref, rel):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    np.testing.assert_allclose(out, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("M,K,N", [(1, 1408, 256), (1, 512, 384),
                                   (8, 1408, 256)],
                         ids=["m1_group_tail", "m1", "m8"])
def test_k1_plain_matches_pallas_interpret(M, K, N):
    jnpk, qt = _weights(K, N, seed=M + K)
    x = _x(M, K, seed=7)
    ref = jqmatmul(jnp.asarray(x, jnp.bfloat16), jnpk, out_dtype=jnp.float32,
                   interpret=True)
    args = (qt.planes[0], qt.scales, None, qt.group_size, 4, torch.float32)
    out = qmm_native_plain(torch.from_numpy(x), *args)
    _close(out.numpy(), ref, 1e-5)
    # the wrapper on a CPU tensor is the plain version
    torch.testing.assert_close(qmm_native(torch.from_numpy(x), *args), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("N", [256, 640], ids=["in_kernel_quant",
                                               "external_quant"])
def test_k2_plain_matches_pallas_interpret(N):
    M, K = 256, 512
    jnpk, qt = _weights(K, N, seed=N)
    x = _x(M, K, seed=11)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jqmatmul(xb, jnpk, out_dtype=jnp.float32, interpret=True)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    gd = _pick_a8(M, K, N, qt)
    assert gd == 128
    out = qmm_a8_plain(xt, qt.planes[0], qt.scales, qt.group_size, gd,
                       torch.float32)
    ok = np.ones(M, bool)
    if N == 256:
        # The in-kernel quantization, run by XLA on the CPU under jit, is
        # not IEEE division: a few codes land one step off the
        # quantize_act_i8 codes (ROADMAP.md section C). Rows holding such a
        # code are excluded here — and must be exactly the rows that differ.
        flipped = (_jit_in_kernel_codes(xb, gd)
                   != np.asarray(jquantize_act_i8(xb, gd)[0])).any(axis=1)
        ok = ~flipped
        assert flipped.sum() < M // 8
        ref_np, out_np = np.asarray(ref), out.numpy()
        assert (np.abs(out_np - ref_np)[flipped].max(axis=1) > 1e-4).all()
    _close(out.numpy()[ok], np.asarray(ref)[ok], 1e-5)
    torch.testing.assert_close(
        qmm_a8(xt, qt.planes[0], qt.scales, qt.group_size, gd,
               torch.float32), out, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_act_quant_codes_equal(dtype):
    x = _x(300, 512, seed=5) * 3
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    jq, jsa = jquantize_act_i8(jx, 128)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    if dtype == "bf16":
        tx = tx.bfloat16()
    q, sa = quantize_act_i8(tx, 128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    q2, sa2 = act_quant_i8(tx, 128)           # CPU tensor: the plain version
    assert torch.equal(q2, q) and torch.equal(sa2, sa)


def test_k1_at_m40_matches_qmatmul_native():
    jnpk, qt = _weights(512, 256, seed=40)
    x = _x(40, 512, seed=3)
    ref = jqmatmul_native(jnp.asarray(x), jnpk, out_dtype=jnp.float32)
    out = qmatmul(torch.from_numpy(x), qt, torch.float32)
    _close(out.numpy(), ref, 1e-2)


def test_dispatch_a8_matches_jax_oracle():
    """M >= 256 with act_bits=8 takes the int8 path in both packages; the
    JAX CPU path is ``matmul_a8_ref``."""
    jnpk, qt = _weights(512, 256, seed=300)
    x = _x(300, 512, seed=4)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jmatmul_a8_ref(xb, jnpk, 128, dtype=jnp.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    out = qmatmul(xt, qt, torch.float32)
    _close(out.numpy(), ref, 1e-5)
    _close(matmul_a8_ref(xt, qt, 128, torch.float32).numpy(), ref, 1e-6)
    # leading dims pass through
    assert qmatmul(xt.reshape(3, 100, 512), qt).shape == (3, 100, 256)


def test_dispatch_rejects_what_this_slice_does_not_run():
    """What the dispatch once refused now runs as the JAX package runs it:
    an act-order weight gathers x by its perm first (JAX's ``gathered``),
    a mixed preset's name gives its registry (JAX's rules), and the
    int8-activation path takes int8 code planes at rest (JAX's
    ``matmul_a8_ref`` on the CPU). What still raises: the int8-activation
    path over a weight not at rest. The stored layouts, bf16 activations
    at any M and asymmetric weights are taken."""
    import dataclasses
    from neural_tpu.api import quant_config_from_args as jqcfa
    from neural_tpu.core.dtypes import QuantConfig as JQC
    from neural_tpu.core.qtensor import to_native as jto_native
    from neural_tpu_torch.api import quant_config_from_args
    from neural_tpu_torch.core.dtypes import QuantConfig
    from neural_tpu_torch.core.qtensor import to_native
    rng = torch.Generator().manual_seed(0)
    w = torch.randn(256, 128, generator=rng)
    packed = quantize(w, PRESETS["q4_j"])
    assert qmatmul(torch.randn(2, 256), packed).shape == (2, 128)   # K5
    with pytest.raises(ValueError):
        qmatmul(torch.randn(300, 256), packed)   # K2 reads codes at rest only
    act16 = to_native_packed(quantize(w, PRESETS["q4_0"]))
    assert qmatmul(torch.randn(2, 256), act16).shape == (2, 128)
    assert qmatmul(torch.randn(300, 256), act16).shape == (300, 128)
    asym = to_native_packed(quantize(w, PRESETS["q4_1"]))
    assert qmatmul(torch.randn(2, 256), asym).shape == (2, 128)
    # act-order: the same as the gathered x through the weight without perm
    jnpk, _ = _weights(256, 128, seed=5, preset="q4_0")
    perm = np.random.default_rng(1).permutation(256).astype(np.int32)
    jperm = dataclasses.replace(jnpk, perm=jnp.asarray(perm))
    qperm = qtensor_from_numpy(jax_qtensor_to_numpy(jperm), "cpu")
    x = _x(2, 256, seed=6)
    ref = jqmatmul_native(jnp.asarray(x)[:, perm], jnpk,
                          out_dtype=jnp.float32)
    _close(qmatmul(torch.from_numpy(x), qperm, torch.float32).numpy(), ref,
           1e-2)
    # mixed presets: the registry, with JAX's rules
    reg, jreg = quant_config_from_args("mix_int2_int4"), jqcfa("mix_int2_int4")
    assert [(p, c.__dict__) for p, c in reg.rules] == \
        [(p, c.__dict__) for p, c in jreg.rules]
    # a8 over int8 code planes: at rest it takes K2, as JAX's oracle
    a8_int8 = quantize(w, QuantConfig(bits=8, group_size=128, act_bits=8))
    assert qmatmul(torch.randn(2, 256), a8_int8).shape == (2, 128)
    with pytest.raises(ValueError):
        qmatmul(torch.randn(300, 256), a8_int8)     # not at rest: refused
    jq8 = jto_native(jquantize(jnp.asarray(w.numpy()),
                               JQC(bits=8, group_size=128, act_bits=8)))
    q8 = qtensor_from_numpy(jax_qtensor_to_numpy(jq8), "cpu")
    assert q8.planes[0].dtype == torch.int8
    assert torch.equal(to_native(a8_int8).planes[0], q8.planes[0])
    xb = jnp.asarray(_x(300, 256, seed=7), jnp.bfloat16)
    ref8 = jmatmul_a8_ref(xb, jq8, 128, dtype=jnp.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    _close(qmatmul(xt, q8, torch.float32).numpy(), ref8, 1e-5)
