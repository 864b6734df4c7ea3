"""The plain versions of K5 and of K1's and K2's new branches against the
JAX package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_qmatmul.py`` runs them, on the same numpy inputs (weights
quantized by JAX, carried over by the bridge).

Tolerances:
- K5 vs ``_qmatmul_pallas``: rtol 1e-5 plus 1e-5·max|ref| in f32. Both round
  the dequantized tile to bf16 the same way (f32 value times f32 scale,
  rounded once) and multiply bf16 by bf16 into f32; the products are exact,
  so only the order of the sums differs.
- K1 vs ``_qmatmul4_pallas``: the same 1e-5 — both take f32 codes times f32
  scales per group and the same f32 zero-point correction ``xs @ (z·s)``;
  only the order of the sums differs.
- K2-asym vs ``_qmatmul_a8_pallas``: 1e-5 — equal int8 activation codes,
  exact integer dots, the same f32 fold; the start ``-(xsa @ zwp)`` is an
  f32 product summed in another order.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.core.dtypes import PRESETS as JPRESETS, QuantConfig as JQC
from neural_tpu.core.qtensor import (quantize as jquantize,
                                     to_native as jto_native,
                                     to_native_packed as jto_native_packed)
from neural_tpu.ops.qmatmul import qmatmul as jqmatmul

# the module (``neural_tpu.ops`` exports its function of the same name)
jqmatmul_mod = importlib.import_module("neural_tpu.ops.qmatmul")

from neural_tpu_torch.convert.from_jax import qtensor_from_numpy
from neural_tpu_torch.ops.qmatmul import (
    _pick_a8, qmm_a8, qmm_a8_plain, qmm_general, qmm_general_plain,
    qmm_native, qmm_native_plain, qmatmul)
from test_torch_bridge import jax_qtensor_to_numpy

K, N = 256, 128

# the formats of tests/test_qmatmul.py:33-47 (stored layouts), native-pack
# sym/asym 3- and 4-bit and int2, int8 code planes sym and asym, and float
# zero-points
FORMATS = {
    **{p: (JPRESETS[p], None) for p in (
        "q4_0", "q4_1", "q8_0", "int8", "int5", "int3", "int2", "int1",
        "nf4", "fp4", "fp8", "fp8_e5m2", "q4_j_g128")},
    "npack_int4_sym": (JQC(bits=4, group_size=32), "npack"),
    "npack_int4_asym": (JQC(bits=4, group_size=32, sym=False), "npack"),
    "npack_int3_sym": (JQC(bits=3, group_size=32), "npack"),
    "npack_int3_asym": (JQC(bits=3, group_size=64, sym=False), "npack"),
    "npack_int2_sym": (JQC(bits=2, group_size=32), "npack"),
    "npack_int2_asym": (JQC(bits=2, group_size=32, sym=False), "npack"),
    "int8_codes_sym": (JQC(bits=8, group_size=32), "native"),
    "int8_codes_asym": (JQC(bits=8, group_size=64, sym=False), "native"),
    "int8_codes_per_channel": (JQC(bits=8, group_size=-1), "native"),
    "float_zeros": (JQC(bits=4, group_size=32, sym=False), "float_zeros"),
}


def _pair(name, K=K, N=N):
    jcfg, layout = FORMATS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jqt = jquantize(jnp.asarray(w), jcfg)
    if layout == "npack":
        jqt = jto_native_packed(jqt)
    elif layout == "native":
        jqt = jto_native(jqt)
    elif layout == "float_zeros":     # GGUF Q4_1 style: w = q*d + m
        jqt = dataclasses.replace(
            jqt, zeros=jqt.zeros.astype(jnp.float32) + 0.25)
    return jqt, qtensor_from_numpy(jax_qtensor_to_numpy(jqt), "cpu")


def _x(M, K, seed):
    return np.random.default_rng(seed).standard_normal((M, K)) \
        .astype(np.float32)


def _close(out, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


def _pallas_k5(x, jqt):
    """``_qmatmul_pallas`` in interpret mode with the tiles the JAX
    dispatch picks, x padded to the M tile as it pads it. Int8 code planes
    go in with ``bits=8``: for 5-7 bit weights the launcher builds one
    BlockSpec per bit plane from ``cfg.bits`` (``_qmatmul_pallas``,
    :568-577) while the tensor holds one int8 plane, and refuses the call
    (ROADMAP.md section C); the kernel's dequant of int8 planes does not
    read the width."""
    M = x.shape[0]
    if jqt.planes[0].dtype == jnp.int8:
        jqt = dataclasses.replace(
            jqt, cfg=dataclasses.replace(jqt.cfg, bits=8))
        tiles = jqmatmul_mod._pick_tiles(M, K, N, jqt.group_size, 4,
                                         "fp8__native")
    elif jqt.cfg.native_pack:
        tiles = jqmatmul_mod._pick_tiles(M, K, N, jqt.group_size, 4, "int")
    else:
        tiles = jqmatmul_mod._pick_tiles(M, K, N, jqt.group_size,
                                         jqt.cfg.bits, jqt.cfg.kind)
    tm = tiles[0]
    Mp = -(-M // tm) * tm
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, Mp - M), (0, 0)))
    out = jqmatmul_mod._qmatmul_pallas(xp, jqt, *tiles,
                                       out_dtype=jnp.float32, interpret=True)
    return np.asarray(out)[:M]


@pytest.mark.parametrize("M", [1, 40, 300])
@pytest.mark.parametrize("name", list(FORMATS))
def test_k5_plain_matches_pallas_interpret(name, M):
    jqt, qt = _pair(name)
    x = _x(M, K, seed=M)
    ref = _pallas_k5(x, jqt)
    out = qmm_general_plain(torch.from_numpy(x), qt, torch.float32)
    _close(out.numpy(), ref)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(qmm_general(torch.from_numpy(x), qt, torch.float32),
                       out)


K1_FORMATS = ["npack_int4_asym", "npack_int3_asym", "npack_int2_sym",
              "npack_int2_asym", "int8_codes_sym", "int8_codes_asym",
              "int8_codes_per_channel"]


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("name", K1_FORMATS)
def test_k1_branches_match_pallas_interpret(name, M):
    """K1's asym, int2 and int8-code branches: the JAX dispatch sends these
    native tensors to ``_qmatmul4_pallas`` at M <= 16 (the m1 branch at
    M = 1), and so does the port's."""
    jqt, qt = _pair(name, K=384, N=256)   # 12 groups of 32: an m1 group tail
    x = _x(M, 384, seed=M + 1)
    ref = jqmatmul(jnp.asarray(x, jnp.bfloat16), jqt, out_dtype=jnp.float32,
                   interpret=True)
    args = (qt.planes[0], qt.scales, qt.zeros, qt.group_size, qt.cfg.bits,
            torch.float32)
    out = qmm_native_plain(torch.from_numpy(x), *args)
    _close(out.numpy(), ref)
    assert torch.equal(qmm_native(torch.from_numpy(x), *args), out)
    assert torch.equal(qmatmul(torch.from_numpy(x), qt, torch.float32), out)


@pytest.mark.parametrize("N2", [256, 640])
def test_k2_asym_plain_matches_pallas_interpret(N2):
    """q4_j_i8_g128 at M = 256: the JAX dispatch quantizes x outside the
    kernel (asymmetric weights never take the in-kernel quantization), with
    ``quantize_act_i8``'s eager codes, the port's codes; no row is left
    out."""
    M, K2 = 256, 512
    rng = np.random.default_rng(N2)
    w = (rng.standard_normal((K2, N2)) * 0.05).astype(np.float32)
    jqt = jto_native_packed(jquantize(jnp.asarray(w),
                                      JPRESETS["q4_j_i8_g128"]))
    qt = qtensor_from_numpy(jax_qtensor_to_numpy(jqt), "cpu")
    x = _x(M, K2, seed=11)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jqmatmul(xb, jqt, out_dtype=jnp.float32, interpret=True)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    gd = _pick_a8(M, K2, N2, qt)
    assert gd == 128 and qt.zeros is not None
    args = (qt.planes[0], qt.scales, qt.group_size, gd, torch.float32,
            qt.zeros)
    out = qmm_a8_plain(xt, *args)
    _close(out.numpy(), ref)
    assert torch.equal(qmm_a8(xt, *args), out)
    assert torch.equal(qmatmul(xt, qt, torch.float32), out)
