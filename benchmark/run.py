"""The benchmark's entry: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout (``benchmark/harness.py`` says what it does).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    from benchmark.harness import main
    sys.exit(main())
