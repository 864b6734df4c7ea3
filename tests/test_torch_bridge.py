"""The bridge between the packages: a JAX param tree as numpy, read by the
port's ``convert.from_jax``. bf16 travels as its uint16 bit pattern, fp8 as
its uint8 bit pattern and a QTensor as a dict of its fields; every round
trip must be exact.

``jax_tree_to_numpy`` here is the test side of the bridge; the other
``test_torch_*`` files import it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.core.qtensor import QTensor as JQTensor
from neural_tpu.core.qtensor import quantize as jquantize
from neural_tpu.core.qtensor import to_native_packed as jto_native_packed
from neural_tpu.core.qtensor import (dequantize as jdequantize,
                                     to_native as jto_native)
from neural_tpu.core.dtypes import PRESETS as JPRESETS, QuantConfig as JQC

from neural_tpu_torch.convert.from_jax import (
    params_from_numpy, qtensor_from_numpy, tensor_from_numpy,
    tensor_to_numpy)
from neural_tpu_torch.core.qtensor import dequantize
from neural_tpu_torch.models.config import ModelConfig


def jax_array_to_numpy(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    if a.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2):
        return a.view(np.uint8)
    return a


def jax_qtensor_to_numpy(qt):
    opt = lambda a: None if a is None else jax_array_to_numpy(a)
    return {"planes": [jax_array_to_numpy(p) for p in qt.planes],
            "scales": jax_array_to_numpy(qt.scales),
            "zeros": opt(qt.zeros), "perm": opt(qt.perm),
            "cfg": dataclasses.asdict(qt.cfg)}


def jax_tree_to_numpy(tree):
    """A JAX param pytree → the numpy tree ``params_from_numpy`` reads."""
    if isinstance(tree, JQTensor):
        return jax_qtensor_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return jax_array_to_numpy(tree)


def to_np(t: torch.Tensor) -> np.ndarray:
    return tensor_to_numpy(t)


@pytest.mark.parametrize("shape", [(7,), (33, 65), (2, 3, 128)])
def test_bf16_round_trip_exact(shape):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 37,
                    jnp.bfloat16)
    bits = jax_array_to_numpy(x)
    assert bits.dtype == np.uint16
    t = tensor_from_numpy(bits, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(t), bits)
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))


def test_f32_and_int_leaves_pass_unchanged():
    for a in (np.arange(12, dtype=np.float32).reshape(3, 4),
              np.arange(5, dtype=np.int32), np.arange(6, dtype=np.uint8)):
        t = tensor_from_numpy(a, "cpu")
        np.testing.assert_array_equal(to_np(t), a)
        assert to_np(t).dtype == a.dtype


@pytest.mark.parametrize("cfg", [JPRESETS["q4_j"], JPRESETS["q4_0"],
                                 JQC(bits=4, group_size=32, sym=False)],
                         ids=["q4_j", "q4_0", "int4_g32_asym"])
def test_qtensor_fields_round_trip(cfg):
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((256, 96)).astype(np.float32))
    jqt = jto_native_packed(jquantize(w, cfg))
    d = jax_qtensor_to_numpy(jqt)
    qt = qtensor_from_numpy(d, "cpu")
    assert dataclasses.asdict(qt.cfg) == dataclasses.asdict(jqt.cfg)
    assert qt.shape == jqt.shape and qt.group_size == jqt.group_size
    np.testing.assert_array_equal(to_np(qt.planes[0]), d["planes"][0])
    np.testing.assert_array_equal(to_np(qt.scales), d["scales"])
    if jqt.zeros is None:
        assert qt.zeros is None
    else:
        np.testing.assert_array_equal(to_np(qt.zeros), d["zeros"])


@pytest.mark.parametrize("cfg,to_rest", [
    (JPRESETS["fp8"], None), (JPRESETS["fp8_e5m2"], None),
    (JPRESETS["int5"], jto_native), (JQC(bits=6, group_size=64, sym=False),
                                     jto_native),
    (JQC(bits=8, group_size=-1), jto_native), (JPRESETS["nf4"], None),
    (JPRESETS["int1"], None)],
    ids=["fp8_e4m3", "fp8_e5m2", "int5_codes", "int6_asym_codes",
         "int8_codes_per_channel", "nf4", "int1"])
def test_fp8_and_int8_code_qtensors_cross(cfg, to_rest):
    """fp8 planes come across as their bytes and are read back as the fp8
    kind the cfg names; int8 code planes and their bf16 zero-points as
    themselves."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((256, 96)).astype(np.float32)
    w[0, 0] = 1e4                                 # a saturating outlier
    jqt = jquantize(jnp.asarray(w), cfg)
    if to_rest is not None:
        jqt = to_rest(jqt)
    d = jax_qtensor_to_numpy(jqt)
    qt = qtensor_from_numpy(d, "cpu")
    assert dataclasses.asdict(qt.cfg) == dataclasses.asdict(jqt.cfg)
    assert qt.shape == jqt.shape
    for p, jp, raw in zip(qt.planes, jqt.planes, d["planes"]):
        np.testing.assert_array_equal(to_np(p), raw)
        if cfg.kind.startswith("fp8"):
            assert p.dtype == {"fp8_e4m3": torch.float8_e4m3fn,
                               "fp8_e5m2": torch.float8_e5m2}[cfg.kind]
            np.testing.assert_array_equal(
                p.float().numpy(), np.asarray(jp.astype(jnp.float32)))
    if to_rest is not None:
        assert qt.planes[0].dtype == torch.int8
    np.testing.assert_array_equal(to_np(qt.scales), d["scales"])
    if jqt.zeros is not None:
        np.testing.assert_array_equal(to_np(qt.zeros), d["zeros"])
    np.testing.assert_array_equal(dequantize(qt).numpy(),
                                  np.asarray(jdequantize(jqt)))


def test_stacked_and_per_layer_trees_build_the_same_model():
    """``layers`` as one dict of [L, ...] stacks or as per-layer dicts."""
    from neural_tpu.convert.hf import init_random as jinit_random
    from neural_tpu.models.config import ModelConfig as JMC
    kw = dict(vocab_size=128, hidden_size=256, n_layers=2, n_heads=2,
              n_kv_heads=1, head_dim=128, intermediate_size=512,
              max_seq_len=256)
    jparams = jinit_random(JMC(**kw), seed=3, quant="q4_j")
    stacked = jax_tree_to_numpy(jparams)
    per_layer = dict(stacked)
    per_layer["layers"] = [
        jax_tree_to_numpy(jax.tree.map(lambda a: a[i], jparams["layers"]))
        for i in range(2)]
    a = params_from_numpy(stacked, ModelConfig(**kw), "cpu").state_dict()
    b = params_from_numpy(per_layer, ModelConfig(**kw), "cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
