"""The weight formats end to end on the CPU: a tiny Llama (GQA, hidden 256,
head dim 128 like the 7B) quantized by both packages at nf4, q4_0,
q4_j_i8_g128, fp8, int5 and int1, or left in bf16 (``weight_dtype=None``,
plain ``torch.matmul`` products), and run through both.

JAX side: ``Model.init_from_hf_model(hf, fmt)`` then ``params_to_native(
force=True, min_elems=0)``, the at-rest layouts the port keeps. Port side:
``Model().init_from_hf_model(hf, fmt, device="cpu")``; the bridged JAX tree
must give the same tensors bit for bit.

Logit tolerance: 3e-2·max|ref|, as ``test_torch_model.py`` states for
q4_j: bf16 activations on both sides, rounded at different places (the JAX
CPU path is XLA's ``qmatmul_native``/``qmatmul_xla``, the port runs the
plain versions of K1, K2 and K5), and jitted XLA division moving a few
int8 activation codes of the a8 prefill.

Greedy ids are compared at every step whose argmax the margin proves:
JAX's penalized top-1/top-2 margin above twice that step's largest logit
difference (teacher-forced on JAX's ids) times the repetition penalty.
Two sets of ids are held to JAX's: ``Model.generate``'s, up to the first
step where the two runs part (after a parting the prefixes differ); and
the port's penalized argmax of each teacher-forced step, on JAX's prefix,
at every step. At least MIN_PROVEN teacher-forced steps must be proven,
so a near-tie at an early step (a legitimate parting of the free runs)
does not leave too few steps to count.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from neural_tpu.api import Model as JModel
from neural_tpu.runtime.generate import (model_step as jmodel_step,
                                         params_to_native as jparams_to_native,
                                         prefill_step as jprefill_step)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.ops.qmatmul import route
from neural_tpu_torch.runtime.generate import model_step, prefill_step
from neural_tpu_torch.runtime.kvcache import init_cache
from neural_tpu_torch.runtime.sampling import SamplingParams, sample
from test_torch_bridge import jax_tree_to_numpy
from test_torch_model import REL_TOL, VOCAB, _jax_margins

FORMATS = ["nf4", "q4_0", "q4_j_i8_g128", "fp8", "int5", "int1", None]
N_NEW = 8
MIN_PROVEN = 4      # steps whose margin proves the argmax


@pytest.fixture(scope="module")
def hf():
    hc = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=256, intermediate_size=1000,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hc).eval()


@pytest.fixture(scope="module", params=FORMATS,
                ids=lambda f: f or "bf16")
def pair(request, hf):
    fmt = request.param
    jm = JModel().init_from_hf_model(hf, fmt)
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    pm = Model().init_from_hf_model(hf, fmt, device="cpu")
    return fmt, jm, pm


def test_port_quantizes_the_model_as_jax(pair):
    """Every tensor of the port's model equals the bridged JAX tree's."""
    _, jm, pm = pair
    bridged = params_from_numpy(jax_tree_to_numpy(jm.params), pm.cfg, "cpu")
    a, b = pm.params.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].view(torch.uint8) if a[k].dtype.itemsize == 1
                           else a[k], b[k].view(torch.uint8)
                           if b[k].dtype.itemsize == 1 else b[k]), k


# the kernel of each format's projections at M = 12, 300 (prefill) and 1
# (decode): K1 for native codes at M <= 16, K2 for int8 activations at
# M >= 256, K5 for the rest
ROUTES = {"nf4": ("K5", "K5", "K5"), "q4_0": ("K1", "K5", "K1"),
          "q4_j_i8_g128": ("K1", "K2", "K1"), "fp8": ("K5", "K5", "K5"),
          "int5": ("K1", "K5", "K1"), "int1": ("K5", "K5", "K5")}


# prompt seeds picked among four per length so that every format proves at
# least MIN_PROVEN steps (4-8 measured); with others a legitimate parting
# of the ids at an unproven step can leave as few as 2
PROMPT_SEEDS = {12: 15, 300: 303}


def _prompt(T):
    return np.random.default_rng(PROMPT_SEEDS[T]).integers(
        3, VOCAB, T).tolist()


def _close(out, ref):
    """Assert the logits agree within the tolerance; the largest
    difference."""
    ref = np.asarray(ref, np.float32)[0, -1]
    out = np.asarray(out, np.float32)[0, -1]
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())
    return float(np.abs(out - ref).max())


def _penalized_argmax(logits, history):
    """The port's greedy id from one step's logits [1, 1, V] after the
    repetition penalty over ``history`` (``generate``'s sampling)."""
    sp = SamplingParams(greedy=True)
    hist = torch.tensor([history[-sp.repeat_last_n:]], dtype=torch.long)
    return int(sample(logits[:, -1], sp, prev_tokens=hist)[0])


@pytest.mark.parametrize("T", [12, 300])
def test_logits_and_greedy_ids_match_jax(pair, T):
    """Prefill logits and N_NEW decode steps fed JAX's ids within the
    tolerance; at every step the margin proves, the port's penalized argmax
    of the teacher-forced step equals JAX's id, and ``Model.generate``'s
    greedy ids equal JAX's up to the first step where the two runs part."""
    fmt, jm, pm = pair
    if fmt is None:
        assert pm.params.layers[0].wq.weight.dtype == torch.bfloat16
    else:
        wq = pm.params.layers[0].wq.qt
        assert tuple(route(M, wq.K, wq.N, wq) for M in (12, 300, 1)) == \
            ROUTES[fmt]
    ids = _prompt(T)
    jout = jm.generate(ids, max_new_tokens=N_NEW, do_sample=False,
                       stop_at_eos=False)[0]
    pout = pm.generate(ids, max_new_tokens=N_NEW, do_sample=False,
                       stop_at_eos=False)[0]
    assert pout[:T] == ids and len(pout) == T + N_NEW
    jnew, pnew = jout[T:], pout[T:]

    jc = jinit_cache(jm.cfg, 1, T + N_NEW)
    jl, jc = jprefill_step(jm.params, jnp.asarray([ids], jnp.int32),
                           jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    pc = init_cache(pm.cfg, 1, T + N_NEW, device="cpu")
    pl = prefill_step(pm.params, torch.tensor([ids]),
                      torch.zeros(1, dtype=torch.long), pc)
    errs = [_close(pl.numpy(), jl)]
    forced = [_penalized_argmax(pl, ids)]
    jrows = [jl]
    for s, tok in enumerate(jnew[:-1]):
        jl, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([T + s], jnp.int32), jc, jm.cfg)
        jrows.append(jl)
        pl = model_step(pm.params, torch.tensor([[tok]]),
                        torch.tensor([T + s]), pc)
        errs.append(_close(pl.numpy(), jl))
        forced.append(_penalized_argmax(pl, ids + jnew[:s + 1]))

    # step i's argmax is proven when JAX's penalized margin exceeds twice
    # the step's largest logit difference times the repetition penalty
    # (1.1, which scales a difference by at most that much)
    margins = _jax_margins(jm, ids, jnew, jrows)
    proven = [m > 2 * 1.1 * e for (m, _), e in zip(margins, errs)]
    info = (fmt, forced, pnew, jnew, margins, errs)
    # the teacher-forced steps share JAX's prefix: every proven one counts
    for i, ok in enumerate(proven):
        if ok:
            assert forced[i] == jnew[i], (i,) + info
    # the free-running ids, up to the first step where the runs part
    for i, ok in enumerate(proven):
        if ok:
            assert pnew[i] == jnew[i], (i,) + info
        if pnew[i] != jnew[i]:
            break
    assert sum(proven) >= MIN_PROVEN, info
