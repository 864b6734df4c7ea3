"""The harness end to end on the CPU at tiny sizes, through ``run.py``'s
code path (the port's plain versions stand in for its kernels)."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, cell, trace=0, seed=3_000_000_123, capsys=None):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "6", "--trace", str(trace)],
                      root=root, device="cpu")
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("cell", ["tiny-mistral.tiny-serve",
                                  "tiny-mixtral.tiny-serve"])
def test_tiny_cell_end_to_end(tiny_root, capsys, cell):
    rc, line, err = run(tiny_root, cell, capsys=capsys)
    assert rc == 0
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) >= {"output_tok_s", "setup_s"}
    assert "time to first token p50 / p90" in err
    # the compared numbers, beside their limits, are the last lines of
    # standard error
    assert err.strip().splitlines()[-1].startswith("check max_gap")


def test_traced_run_reports_per_layer_metrics(tiny_root, capsys):
    rc, line, _ = run(tiny_root, "tiny-mistral.tiny-serve", trace=1,
                      capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert {"pickup_ms_p90.tok_s", "step_ms.tok_s",
            "mfu.tok_s"} <= set(line["metrics"])
    assert 0 < line["metrics"]["mfu.tok_s"]["value"] < 100
    assert "output_tok_s" not in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_late_requests_are_not_failed(tiny_root, capsys):
    """With no time to drain, the requests the server still holds at the
    window's end are late: left out of the check and of ``failed``."""
    path = tiny_root / "benchmark" / "traffic" / "tiny-serve.json"
    path.write_text(json.dumps(dict(
        json.loads(path.read_text()), drain_s=0,
        output={"median": 200, "sigma": 0.1, "min": 150, "max": 250})))
    rc, line, err = run(tiny_root, "tiny-mistral.tiny-serve", capsys=capsys)
    assert rc == 0
    assert "late: " in err
    assert line["failed"] == 0
    # correct as long as some request was answered to compare (a loaded
    # machine may answer none inside the window)
    checked = int(re.search(r"reference check .* over (\d+) requests",
                            err).group(1))
    assert line["correct"] is (checked > 0)


def test_new_mix_and_metric_are_found_by_name(tiny_root, capsys):
    """A later change adds a mix and a metric as new files only."""
    b = tiny_root / "benchmark"
    mix = json.loads((b / "traffic" / "tiny-serve.json").read_text())
    mix["output"] = {"median": 3, "sigma": 0.1, "min": 3, "max": 3}
    (b / "traffic" / "tiny-other.json").write_text(json.dumps(mix))
    (b / "metrics" / "calls_made").mkdir()
    (b / "metrics" / "calls_made" / "reader.py").write_text(
        "def read(rec, ctx, folder):\n    return len(rec['requests'])\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-mistral.other",
                              "config": "tiny-mistral",
                              "traffic": "tiny-other", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "calls_made", "unit": "calls",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-mistral.other"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(b / "limits" / "tiny-mistral.tiny-serve.json",
                b / "limits" / "tiny-mistral.other.json")
    rc, line, _ = run(tiny_root, "tiny-mistral.other", capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["calls_made"]["value"] == line["attempted"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.model, benchmark.weights; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('neural_tpu_torch', 'neural_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    """After a whole run, no loaded module's top-level name is jax,
    jaxlib, flax or neural_tpu (compared whole: neural_tpu_torch is the
    program)."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark import harness; "
            "rc = harness.main(['--workload', 'tiny-mixtral.tiny-serve', "
            "'--seed', '5', '--seconds', '1', '--trace', '0'], root=%r, "
            "device='cpu'); "
            "assert 'neural_tpu_torch' in sys.modules; "
            "print('FORBIDDEN', harness.forbidden_modules()); "
            "sys.exit(rc)" % (str(ROOT), str(tiny_root)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FORBIDDEN []" in r.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "neural_tpu_torch_x", object())
    assert "neural_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "neural_tpu.ops", object())
    assert "neural_tpu" in harness.forbidden_modules()


def test_no_card_or_no_program_prints_no_result(tmp_path):
    """Without a card, or in a folder that holds only BENCHMARK.json and
    the benchmark, the command exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "mistral-7b.serve", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
