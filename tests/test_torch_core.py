"""Port core formats against the JAX package: quantized planes, scales,
zero-points and native-pack bytes must be bit-equal; dequantize exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.core.dtypes import PRESETS as JPRESETS, QuantConfig as JQC
from neural_tpu.core.qtensor import (dequantize as jdequantize,
                                     quantize as jquantize,
                                     to_native_packed as jto_native_packed)

from neural_tpu_torch.core.dtypes import PRESETS, QuantConfig, bit_planes
from neural_tpu_torch.core.qtensor import (dequantize, matmul_ref, quantize,
                                           to_native_packed)
from test_torch_bridge import jax_array_to_numpy, to_np

CASES = {
    "q4_j": (JPRESETS["q4_j"], PRESETS["q4_j"], (512, 192)),
    "q4_0": (JPRESETS["q4_0"], PRESETS["q4_0"], (256, 160)),
    "int4_g32_asym": (JQC(bits=4, group_size=32, sym=False),
                      QuantConfig(bits=4, group_size=32, sym=False),
                      (256, 96)),
    # g=128 on K=64: one group over K, the QTensor records group_size=64
    "g_gt_k_clamp": (JPRESETS["q4_j"], PRESETS["q4_j"], (64, 128)),
}


def _pair(name):
    jcfg, cfg, shape = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return jquantize(jnp.asarray(w), jcfg), quantize(torch.from_numpy(w), cfg)


def _eq(t, a):
    np.testing.assert_array_equal(to_np(t), jax_array_to_numpy(a))


@pytest.mark.parametrize("name", list(CASES))
def test_quantize_bit_equal(name):
    jqt, qt = _pair(name)
    assert qt.cfg.group_size == jqt.cfg.group_size
    assert qt.shape == jqt.shape
    assert len(qt.planes) == len(jqt.planes)
    for p, jp in zip(qt.planes, jqt.planes):
        _eq(p, jp)
    _eq(qt.scales, jqt.scales)
    if jqt.zeros is None:
        assert qt.zeros is None
    else:
        _eq(qt.zeros, jqt.zeros)


@pytest.mark.parametrize("name", list(CASES))
def test_native_pack_bit_equal(name):
    jqt, qt = _pair(name)
    jn, n = jto_native_packed(jqt), to_native_packed(qt)
    assert n.cfg.native_pack and jn.cfg.native_pack
    assert n.planes[0].shape == (qt.K // 2, qt.N)
    _eq(n.planes[0], jn.planes[0])
    _eq(n.scales, jn.scales)
    if jn.zeros is not None:
        _eq(n.zeros, jn.zeros)
    assert to_native_packed(n) is n          # already at rest


@pytest.mark.parametrize("name", list(CASES))
def test_dequantize_exact(name):
    jqt, qt = _pair(name)
    for a, b in ((qt, jqt), (to_native_packed(qt), jto_native_packed(jqt))):
        np.testing.assert_array_equal(dequantize(a).numpy(),
                                      np.asarray(jdequantize(b)))


@pytest.mark.parametrize("bits", [2, 3, 5, 8])
def test_other_widths_bit_equal(bits):
    """Bit-plane packing of the other int widths (4+2+1 planes)."""
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    jqt = jquantize(jnp.asarray(w), JQC(bits=bits, group_size=32))
    qt = quantize(torch.from_numpy(w), QuantConfig(bits=bits, group_size=32))
    assert len(qt.planes) == len(bit_planes(bits))
    for p, jp in zip(qt.planes, jqt.planes):
        _eq(p, jp)
    np.testing.assert_array_equal(dequantize(qt).numpy(),
                                  np.asarray(jdequantize(jqt)))


def test_matmul_ref_and_unported_kinds():
    _, qt = _pair("q4_0")
    x = torch.randn(3, qt.K)
    ref = x @ dequantize(qt)
    torch.testing.assert_close(matmul_ref(x, qt), ref, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        quantize(torch.zeros(64, 64), PRESETS["nf4"])
