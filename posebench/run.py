"""Run one benchmark cell once and print its result line:

    python3 posebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see posebench/README.md).
"""
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from posebench import harness
    sys.exit(harness.main(start=T_START))
