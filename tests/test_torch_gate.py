"""The port's accuracy gate (``neural_tpu_torch.cli.gate``) against the JAX
package's ``scripts/gate.py`` machinery.

- The gate's weights: ``convert.hf.init_random_numpy`` draws the JAX
  ``init_random``'s numbers, so the port's f32 tree equals the JAX one leaf
  for leaf, value for value.
- Its metric: on those weights (lm_head times ``AMP``) and one fixed corpus
  (the one the port's gate samples), the port's perplexity equals the JAX
  package's within 1e-3 relative at q4_j and int3 (the packages round bf16
  activations at different places; measured 2.5e-4 at q4_j, 6.5e-4 at
  int3).
- Its decision, run as ``main(argv)`` on the CPU against baselines written
  here: no test reads ``baselines/``.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.core.qtensor import QTensor as JQTensor
from neural_tpu.eval import perplexity as jperplexity
from neural_tpu.models.config import ModelConfig as JMC

from neural_tpu_torch.cli import gate
from neural_tpu_torch.convert.hf import build_param_dict, init_random_numpy
from neural_tpu_torch.models import llama
from test_torch_bridge import jax_array_to_numpy, to_np


def _jcfg():
    return JMC(**dataclasses.asdict(gate.gate_cfg()))


def test_numpy_draws_equal_jax_init_random():
    cfg = gate.gate_cfg()
    ref = jinit_random(_jcfg(), seed=0, dtype=jnp.float32)
    port = build_param_dict(init_random_numpy(cfg, 0), cfg, llama,
                            None, torch.float32, "cpu")
    for l, lp in enumerate(port["layers"]):
        for name, t in lp.items():
            np.testing.assert_array_equal(
                to_np(t), jax_array_to_numpy(ref["layers"][name][l]),
                err_msg=f"{name}.{l}")
    names = [k for k in ref if k != "layers"]
    assert set(names) <= set(port)
    for name in names:
        np.testing.assert_array_equal(to_np(port[name]),
                                      jax_array_to_numpy(ref[name]),
                                      err_msg=name)


@pytest.fixture(scope="module")
def corpus():
    return gate.build_corpus(device="cpu")[2]


def _jax_amp(params):
    params = dict(params)
    lm = params["lm_head"]
    params["lm_head"] = dataclasses.replace(lm, scales=lm.scales * gate.AMP) \
        if isinstance(lm, JQTensor) else lm * gate.AMP
    return params


@pytest.mark.parametrize("name", ["q4_j", "int3"])
def test_perplexity_equals_jax_on_the_same_weights(corpus, name):
    from neural_tpu.core.dtypes import PRESETS as JPRESETS
    port, cfg = gate.gate_model(gate.quant_of(name), 0, "cpu")
    jp = _jax_amp(jinit_random(_jcfg(), seed=0, quant=JPRESETS[name],
                               dtype=jnp.float32))
    ref = jperplexity(jp, _jcfg(), corpus, ctx_size=128, stride=64,
                      batch=4)["ppl"]
    out = gate.ppl(port, cfg, corpus)
    assert abs(out / ref - 1) < 1e-3, (out, ref)


def test_gate_main_updates_and_gates(tmp_path):
    out = tmp_path / "ratios.json"
    lines = []
    assert gate.main(["--device", "cpu", "--update", "--out", str(out)],
                     out=lines.append) == 0
    ratios = json.loads(out.read_text())
    assert json.loads(lines[0]) == ratios
    assert set(ratios) == {"fp32_ppl", *gate.GATED}
    assert all(r > 0.9 for r in ratios.values())
    # against its own ratios the gate passes; against ratios 20% lower it
    # fails on every gated config
    assert gate.main(["--device", "cpu", "--baseline", str(out)],
                     out=lines.append) == 0
    low = tmp_path / "low.json"
    low.write_text(json.dumps({k: v / 1.2 for k, v in ratios.items()}))
    assert gate.main(["--device", "cpu", "--baseline", str(low)],
                     out=lines.append) == 1
    assert len(gate.regressions(ratios, json.loads(low.read_text()),
                                0.10)) == len(gate.GATED)
    with pytest.raises(SystemExit):
        gate.parse_args(["--update"])
