"""The port's weight-residency estimates (``runtime/residency.py``): twins of
``tests/test_residency.py``'s byte, threshold and CPU no-op tests, each held
against the JAX package's function on the same tree or cache.

The port keeps every weight native at rest, so its tree is held against the
JAX tree after ``params_to_native(force=True, min_elems=0)``: the two store
the same bytes, leaf for leaf (a QTensor's planes and scales, one byte a
zero-point; the embedding, norms and RoPE table as they are).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.core.qtensor import quantize as jquantize
from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.runtime import init_cache as jinit_cache
from neural_tpu.runtime import residency as jrz
from neural_tpu.runtime.generate import params_to_native as jparams_to_native
from neural_tpu.runtime.kvcache import cache_nbytes as jcache_nbytes

from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.core.dtypes import PRESETS
from neural_tpu_torch.core.qtensor import quantize
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.runtime import residency as rz
from neural_tpu_torch.runtime.kvcache import cache_nbytes, init_cache
from neural_tpu_torch.runtime.paged import init_paged_cache
from test_torch_bridge import jax_tree_to_numpy

KW = dict(arch="llama", vocab_size=256, hidden_size=128, n_layers=2,
          n_heads=8, n_kv_heads=4, head_dim=16, intermediate_size=256,
          max_seq_len=64)
CFG, JCFG = ModelConfig(**KW), JMC(**KW)


@pytest.fixture(scope="module")
def trees():
    """(JAX q4_0 f32 tree, packed; the same at rest; the port's decoder
    carried over from it)."""
    jq = jinit_random(JCFG, quant="q4_0", dtype=jnp.float32)
    jn = jparams_to_native(jq, force=True, min_elems=0)
    return jq, jn, params_from_numpy(jax_tree_to_numpy(jn), CFG, "cpu")


@pytest.mark.parametrize("dt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                    ("int8", "int8"),
                                    (torch.float32, jnp.float32)],
                         ids=["bf16", "int8", "f32"])
def test_kv_bytes_matches_init_cache(dt, jdt):
    cache = init_cache(CFG, 3, 64, dt, device="cpu")
    n = rz.kv_cache_bytes(CFG, 3, 64, dt)
    assert n == cache_nbytes(cache)
    assert n == jrz.kv_cache_bytes(JCFG, 3, 64, jdt)
    assert n == jcache_nbytes(jinit_cache(JCFG, 3, 64, jdt))
    paged = init_paged_cache(CFG, 3, 64, page_size=16, dtype=dt,
                             device="cpu")
    assert cache_nbytes(paged) == n


def test_tree_bytes_equal_the_jax_count(trees):
    jq, jn, port = trees
    assert rz.tree_device_bytes(port) == jrz.tree_device_bytes(jn)
    assert rz.tree_device_bytes(port.param_dict()) == \
        rz.tree_device_bytes(port)
    # at rest nothing is copied inside a decode step, in either package
    assert rz.conv_copy_bytes(port) == jrz.conv_copy_bytes(jn) == 0
    assert jrz.conv_copy_bytes(jq) > 0


@pytest.mark.parametrize("preset", ["q4_0", "int2", "int8",
                                    "int4_g128_asym"])
def test_conv_copy_bytes_of_a_packed_tensor(preset):
    """A packed (bit-plane) QTensor, as ``core.qtensor.quantize`` gives it
    in both packages: the same copy a JAX decode executable would hold."""
    from neural_tpu.core.dtypes import PRESETS as JPRESETS
    from neural_tpu.core.dtypes import QuantConfig as JQC
    from neural_tpu_torch.core.dtypes import QuantConfig
    w = np.random.default_rng(0).standard_normal((256, 384)) \
        .astype(np.float32)
    if preset == "int4_g128_asym":
        qc, jqc = QuantConfig(bits=4, group_size=128, sym=False), \
            JQC(bits=4, group_size=128, sym=False)
    else:
        qc, jqc = PRESETS[preset], JPRESETS[preset]
    qt, jqt = quantize(torch.from_numpy(w), qc), jquantize(jnp.asarray(w),
                                                           jqc)
    assert rz._conv_copy_bytes_one(qt) == jrz._conv_copy_bytes_one(jqt) > 0
    assert qt.nbytes() == jqt.nbytes()


def test_should_go_native_thresholds(trees, monkeypatch):
    jq, _, port = trees
    # the JAX package's override of its answer, unset (the port has none)
    monkeypatch.delenv("NTPU_NATIVE_AT_REST", raising=False)
    for budget, want in ((1 << 40, False), (1 << 20, True)):
        monkeypatch.setenv("NTPU_HBM_BYTES", str(budget))
        assert rz.device_hbm_budget() == budget
        assert rz.should_go_native(port, CFG, 1, 64, torch.bfloat16) == want
        assert jrz.should_go_native(jq, JCFG, 1, 64, jnp.bfloat16) == want
    # the peak sits between the two budgets, one f32 cache the more
    peak = rz.decode_peak_bytes(port, CFG, 1, 64, torch.float32)
    assert peak == rz.tree_device_bytes(port) + rz.kv_cache_bytes(
        CFG, 1, 64, "float32") + rz.TRANSIENT_BYTES


def test_budget_needs_a_card_or_the_variable(monkeypatch):
    monkeypatch.delenv("NTPU_HBM_BYTES", raising=False)
    if torch.cuda.is_available():
        assert rz.device_hbm_budget() > 0
    else:
        with pytest.raises(RuntimeError, match="NTPU_HBM_BYTES"):
            rz.device_hbm_budget()


def test_ensure_noop_on_cpu(trees):
    _, jn, port = trees
    assert rz.ensure_decode_residency(port, CFG, 8, 64, "int8") is port
    assert jrz.ensure_decode_residency(jn, JCFG, 8, 64, "int8") is jn
