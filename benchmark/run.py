"""Run one cell of the benchmark on the card this process is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. See ``benchmark/harness.py``."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this script's folder, so that the
# benchmark's modules import as ``benchmark.*`` and shadow nothing
sys.path[0] = ROOT

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
