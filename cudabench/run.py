"""Run one cell of BENCHMARK.json once and print its result line last.

    python3 cudabench/run.py --workload NAME --seed N --seconds S --trace 0|1

Exits 2, printing no result, without the CUDA cards the cell asks for.
"""

import time

T_PROCESS = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from cudabench import harness

    harness.cache_dirs(ROOT)
    return harness.main(sys.argv[1:], t_process=T_PROCESS)


if __name__ == "__main__":
    raise SystemExit(main())
