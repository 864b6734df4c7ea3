"""The port stands alone: importing ``neural_tpu_torch`` and its modules
(and the imports of ``chip_smoke.py``) pulls in no JAX, no ``neural_tpu``,
no ml_dtypes, no transformers and no safetensors — the machine with the
card has none of them; the port reads checkpoint files itself
(``convert/files.py``, ``convert/stream.py``, ``convert/gguf.py``,
``convert/checkpoint.py``)."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "ml_dtypes", "neural_tpu", "transformers",
          "safetensors")

PROBE = """
import sys
sys.path.insert(0, {root!r})
import {module}
banned = {banned!r}
hit = sorted(m for m in sys.modules
             if m in banned or any(m.startswith(b + ".") for b in banned))
print(",".join(hit))
"""


@pytest.mark.parametrize("module", [
    "neural_tpu_torch", "chip_smoke", "neural_tpu_torch.convert.gptq",
    "neural_tpu_torch.convert.files", "neural_tpu_torch.convert.lora",
    "neural_tpu_torch.convert.quant_registry", "neural_tpu_torch.api",
    "neural_tpu_torch.ops.qmatmul", "neural_tpu_torch.models.transformer",
    "neural_tpu_torch.serving.scheduler", "neural_tpu_torch.convert.gguf",
    "neural_tpu_torch.convert.gguf_models",
    "neural_tpu_torch.convert.checkpoint", "neural_tpu_torch.convert.stream",
    "neural_tpu_torch.tokenizer", "neural_tpu_torch.native",
    "neural_tpu_torch.parallel", "neural_tpu_torch.parallel.sharding",
    "neural_tpu_torch.parallel.tp", "neural_tpu_torch.parallel.ep",
    "neural_tpu_torch.parallel.multihost",
    "neural_tpu_torch.parallel.run_tp", "neural_tpu_torch.parallel.sp",
    "neural_tpu_torch.parallel.pp", "neural_tpu_torch.parallel.dryrun",
    "neural_tpu_torch.parallel.collectives",
    "neural_tpu_torch.models.whisper", "neural_tpu_torch.eval",
    "neural_tpu_torch.eval.perplexity", "neural_tpu_torch.eval.harness",
    "neural_tpu_torch.eval.diff", "neural_tpu_torch.utils",
    "neural_tpu_torch.utils.audio", "neural_tpu_torch.utils.profiling",
    "neural_tpu_torch.utils.prompts", "neural_tpu_torch.runtime.residency",
    "neural_tpu_torch.cli.gate", "neural_tpu_torch.cli.run",
    "neural_tpu_torch.cli.inference", "neural_tpu_torch.cli.quantize",
    "neural_tpu_torch.cli.convert", "neural_tpu_torch.cli.perplexity",
    "neural_tpu_torch.cli.accuracy", "neural_tpu_torch.cli.whisper"])
def test_import_pulls_in_nothing_banned(module):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), module=module,
                                            banned=BANNED)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_banned():
    files = sorted((ROOT / "neural_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported(f)
           if name.split(".")[0] in BANNED]
    assert bad == []


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """With no CUDA device the script exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
