"""Fixtures of the benchmark's own tests: a copy of the benchmark beside a
``BENCHMARK.json`` of tiny cells, run on the CPU through the harness's
code path (the port's plain PyTorch versions stand in for its kernels).

Tests that need the card carry the ``card`` marker and skip without one;
whether there is a card is decided inside the test, never at import."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1, "intermediate_size": 512,
        "vocab_size": 512, "max_position_embeddings": 4096,
        "rms_norm_eps": 1e-5, "hidden_act": "silu", "bos_token_id": 1,
        "eos_token_id": 2, "tie_word_embeddings": False,
        "assumed": {"quant": "q4_j"}}

TINY_SERVE = {
    "driver": "server", "arrivals": {"kind": "poisson", "rate": 3.0},
    "prompt": {"median": 40, "sigma": 0.8, "min": 8, "max": 200},
    "output": {"median": 6, "sigma": 0.3, "min": 4, "max": 8},
    "vocab": [3, 512], "lead_in_s": 0.3,
    "server": {"max_batch": 4, "kv_mode": "paged", "memory_dtype": "int8",
               "page_size": 64, "max_len": 512},
    "warmup": {"prompts": [20, 100], "output": 2},
    "trace": {"after_s": 0.2, "seconds": 0.5}}

def card_available() -> bool:
    import torch
    return torch.cuda.is_available()


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs the CUDA card; skips without one")


def write_tiny(root: Path, limit: float = 1e9):
    """A copy of the benchmark under ``root`` with tiny Mistral and
    Mixtral cells of the served mix."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / "benchmark"
    (b / "configs" / "tiny-mistral.json").write_text(json.dumps(
        dict(TINY, model_type="mistral")))
    (b / "configs" / "tiny-mixtral.json").write_text(json.dumps(
        dict(TINY, model_type="mixtral", num_local_experts=4,
             num_experts_per_tok=2)))
    (b / "traffic" / "tiny-serve.json").write_text(json.dumps(TINY_SERVE))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [
        {"name": n, "source": "test", "file": f"benchmark/configs/{n}.json",
         "reduced": [], "why": "test"} for n in ("tiny-mistral",
                                                "tiny-mixtral")]
    cells = []
    for c in ("tiny-mistral", "tiny-mixtral"):
        name = f"{c}.tiny-serve"
        cells.append({"name": name, "config": c, "traffic": "tiny-serve",
                      "chips": 1, "why": "test"})
        (b / "limits" / f"{name}.json").write_text(json.dumps(
            {"numbers": {"max_gap": limit}, "check": {"min_tokens": 10000,
                                                      "max_requests": 100,
                                                      "masked_ids": [2]}}))
    spec["workloads"] = cells
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny(tmp_path)
