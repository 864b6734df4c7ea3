"""The quantization matrix against the JAX package: every preset's planes
(fp8 as their bytes), scales and zero-points bit-equal, the at-rest int8
code planes of 5-8 bit weights bit-equal, dequantize equal; the
reference-style ``quant_config_from_args``; and the route each (preset, M)
takes — K1, K2 or K5 — by the JAX package's dispatch rule."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.api import quant_config_from_args as jquant_config_from_args
from neural_tpu.core.dtypes import (FP4_LUT as JFP4_LUT, NF4_LUT as JNF4_LUT,
                                    PRESETS as JPRESETS, QuantConfig as JQC)
from neural_tpu.core.qtensor import (centered_codes as jcentered_codes,
                                     dequantize as jdequantize,
                                     is_native as jis_native,
                                     quantize as jquantize,
                                     to_native as jto_native,
                                     to_native_packed as jto_native_packed)

# the module (``neural_tpu.ops`` exports its function of the same name)
jq = importlib.import_module("neural_tpu.ops.qmatmul")

from neural_tpu_torch.api import quant_config_from_args
from neural_tpu_torch.core.dtypes import (FP4_LUT, NF4_LUT, PRESETS,
                                          QuantConfig)
from neural_tpu_torch.core.qtensor import (centered_codes, dequantize,
                                           quantize, to_native)
from neural_tpu_torch.ops.qmatmul import route
from neural_tpu_torch.runtime.generate import params_to_native
from test_torch_bridge import jax_array_to_numpy, to_np

CONFIGS = {name: (JPRESETS[name], PRESETS[name]) for name in PRESETS}
for _bits in (6, 7):
    for _sym in (True, False):
        _kw = dict(bits=_bits, group_size=64, sym=_sym)
        CONFIGS[f"int{_bits}_{'sym' if _sym else 'asym'}_g64"] = (
            JQC(**_kw), QuantConfig(**_kw))
for _kind, _bits in (("int", 1), ("int", 4), ("nf4", 4), ("fp8_e4m3", 8)):
    _kw = dict(kind=_kind, bits=_bits, group_size=-1)
    CONFIGS[f"{_kind}{_bits}_per_channel"] = (JQC(**_kw), QuantConfig(**_kw))


def _weight(name, shape):
    rng = np.random.default_rng(sum(map(ord, name)) + shape[0])
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[3, 5] = 0.0                   # an exact zero, and a large outlier
    w[7, 2] = 1.5
    return w


def _pair(name, shape=(256, 96)):
    jcfg, cfg = CONFIGS[name]
    w = _weight(name, shape)
    return jquantize(jnp.asarray(w), jcfg), quantize(torch.from_numpy(w), cfg)


def _eq(t, a):
    np.testing.assert_array_equal(to_np(t), jax_array_to_numpy(a))


def test_luts_bit_equal():
    for t, a in ((NF4_LUT, JNF4_LUT), (FP4_LUT, JFP4_LUT)):
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      a.view(np.uint32))
    assert FP4_LUT[8].item() == 0.0 and np.signbit(FP4_LUT[8].item())
    assert PRESETS["nf4"].lut is NF4_LUT and PRESETS["fp4"].lut is FP4_LUT
    assert PRESETS["q4_0"].lut is None


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", [(256, 96), (1024, 48)],
                         ids=["K256", "K1024"])
def test_quantize_bit_equal(name, shape):
    jqt, qt = _pair(name, shape)
    assert dataclasses.asdict(qt.cfg) == dataclasses.asdict(jqt.cfg)
    assert qt.shape == jqt.shape and qt.group_size == jqt.group_size
    assert len(qt.planes) == len(jqt.planes)
    for p, jp in zip(qt.planes, jqt.planes):
        _eq(p, jp)
    _eq(qt.scales, jqt.scales)
    if jqt.zeros is None:
        assert qt.zeros is None
    else:
        _eq(qt.zeros, jqt.zeros)
    np.testing.assert_array_equal(dequantize(qt).numpy(),
                                  np.asarray(jdequantize(jqt)))
    assert qt.nbytes() == jqt.nbytes()
    if qt.cfg.kind == "int":
        np.testing.assert_array_equal(centered_codes(qt).numpy(),
                                      np.asarray(jcentered_codes(jqt)))


NATIVE_INT8 = [n for n, (_, c) in CONFIGS.items()
               if c.kind == "int" and c.bits >= 5]


@pytest.mark.parametrize("name", NATIVE_INT8)
def test_to_native_int8_planes_bit_equal(name):
    """5-8 bit weights at rest: centered int8 code planes, bf16 scales and
    shifted bf16 zero-points, as the JAX package's ``to_native``."""
    jqt, qt = _pair(name)
    jn, n = jto_native(jqt), to_native(qt)
    assert n.planes[0].dtype == torch.int8 and jn.planes[0].dtype == jnp.int8
    assert n.shape == jn.shape == qt.shape
    _eq(n.planes[0], jn.planes[0])
    _eq(n.scales, jn.scales)
    if jn.zeros is None:
        assert n.zeros is None
    else:
        _eq(n.zeros, jn.zeros)
    np.testing.assert_array_equal(dequantize(n).numpy(),
                                  np.asarray(jdequantize(jn)))
    assert n.nbytes() == jn.nbytes()
    assert to_native(n) is n


@pytest.mark.parametrize("name", ["int1", "nf4", "fp4", "fp8", "fp8_e5m2"])
def test_to_native_keeps_the_stored_layout(name):
    _, qt = _pair(name)
    assert to_native(qt) is qt
    assert params_to_native({"w": [qt]})["w"][0] is qt


def test_quantize_nf4_in_slices_of_n(monkeypatch):
    """The nearest-entry search runs on slices of N; the codes are per
    element, so the slice size changes nothing."""
    from neural_tpu_torch.core import qtensor
    w = torch.from_numpy(_weight("nf4", (256, 96)))
    whole = quantize(w, PRESETS["nf4"])
    monkeypatch.setattr(qtensor, "_LUT_SLICE_BYTES", 256 * 16 * 4 * 7)
    sliced = quantize(w, PRESETS["nf4"])
    assert torch.equal(whole.planes[0], sliced.planes[0])
    assert torch.equal(whole.scales, sliced.scales)


ARGS = [dict(weight_dtype=w) for w in
        [None, *JPRESETS, "int4", "int2", "int8", "nf4", "fp4", "fp8",
         "fp8_e4m3", "fp8_e5m2"]]
ARGS += [dict(weight_dtype="int4", alg=alg, group_size=g, scale_dtype=sd,
              compute_dtype=cd)
         for alg in ("sym", "asym") for g in (32, 128, -1)
         for sd in ("fp32", "bf16") for cd in ("int8", "bf16")]
ARGS += [dict(weight_dtype=w, group_size=64, scale_dtype="bf16")
         for w in ("nf4", "fp4", "fp8", "fp8_e5m2", "int5", "int1")]
ARGS += [dict(weight_dtype="int4", use_ggml=True),
         dict(weight_dtype="int4", alg="asym", use_ggml=True)]


@pytest.mark.parametrize("kw", ARGS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_quant_config_from_args_equals_jax(kw):
    j, t = jquant_config_from_args(**kw), quant_config_from_args(**kw)
    assert (j is None) == (t is None)
    if j is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_quant_config_from_args_rejects():
    """An unknown name still raises; a mixed preset's name, refused before
    the registry was ported, gives the JAX package's registry."""
    reg, jreg = (quant_config_from_args("mix_int2_int4"),
                 jquant_config_from_args("mix_int2_int4"))
    assert [(p, c.__dict__) for p, c in reg.rules] == \
        [(p, c.__dict__) for p, c in jreg.rules]
    assert reg.default.__dict__ == jreg.default.__dict__
    with pytest.raises(ValueError):
        quant_config_from_args("int9x")
    cfg = QuantConfig(bits=3)
    assert quant_config_from_args(cfg) is cfg


# the Llama-2-7B projections (FFN padded to 11264) and its lm_head
SHAPES_7B = [(4096, 4096), (4096, 11264), (11264, 4096), (4096, 32000)]
MS = [1, 16, 17, 128, 256, 1975]


def _jax_route(M, K, N, jqt):
    """``neural_tpu/ops/qmatmul.py qmatmul``'s choice on the TPU."""
    if jq._pick_a8(M, K, N, jqt.cfg) is not None:
        return "K2"
    if jis_native(jqt):
        code_bits = (8 if jqt.planes[0].dtype == jnp.int8 else
                     8 // (4 if jqt.cfg.bits == 2 else 2))
        if jq._pick_decode_tiles(M, K, N, jqt.group_size,
                                 code_bits) is not None:
            return "K1"
        kind = "int" if jqt.cfg.native_pack else "fp8__native"
        assert jq._pick_tiles(M, K, N, jqt.group_size, 4, kind) is not None
        return "K5"
    assert jq._pick_tiles(M, K, N, jqt.group_size, jqt.cfg.bits,
                          jqt.cfg.kind) is not None
    return "K5"


@pytest.mark.parametrize("name", list(PRESETS))
def test_route_table_matches_jax_rule(name):
    """For every preset at rest (the JAX package's ``params_to_native`` rule
    at every size) and every M of the main paths and the server's chunk
    buckets: the kernel the port routes to is the one the JAX package
    routes to. Shapes only — quantized from a 256 x 128 weight, the
    routes depend on the config and the shape only, so the 7B shapes are
    QTensors of the same config with zero planes of that shape."""
    jqt, qt = _pair(name, (256, 128))
    jn = jto_native_packed(jqt) if (jqt.cfg.kind == "int"
                                    and 2 <= jqt.cfg.bits <= 4) \
        else jto_native(jqt)
    n = to_native(qt)
    assert jis_native(jn) == (n.planes[0].dtype == torch.int8
                              or n.cfg.native_pack)
    routes = {}
    for K, N in SHAPES_7B:
        for M in MS:
            jbig = dataclasses.replace(
                jn, planes=tuple(jnp.zeros((K * p.shape[0] // jn.K, N),
                                           p.dtype) for p in jn.planes))
            big = dataclasses.replace(
                n, planes=tuple(torch.zeros((K * p.shape[0] // n.K, N),
                                            dtype=p.dtype) for p in n.planes))
            want = _jax_route(M, K, N, jbig)
            assert route(M, K, N, big) == want, (name, M, K, N)
            routes[want] = routes.get(want, 0) + 1
    # every preset reaches K5 somewhere; K1 only at rest, K2 only for a8
    assert routes.get("K5", 0) > 0
    assert ("K1" in routes) == (n.planes[0].dtype == torch.int8
                                or n.cfg.native_pack)
    assert ("K2" in routes) == (qt.cfg.act_bits == 8
                                and qt.cfg.group_size % 128 == 0)
