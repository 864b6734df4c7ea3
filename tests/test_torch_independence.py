"""The port stands alone: importing ``neural_tpu_torch`` and its modules
(and the imports of ``chip_smoke.py``) pulls in no JAX, no ``neural_tpu``,
no transformers and no safetensors — the machine with the card has none of
them; the port reads checkpoint files itself (``convert/files.py``)."""
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
    "neural_tpu_torch.serving.scheduler"])
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
