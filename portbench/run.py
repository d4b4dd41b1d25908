"""Run one benchmark cell once and print its result as the last line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see portbench/README.md).

The cell is host-paced, so the interpreter is made the same in every run:
it re-executes itself once with a fixed string-hash seed (the layout of
every dict and set, which otherwise changes from process to process) and
one thread for OpenMP and the BLAS libraries."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEADY_ENV = {"PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1",
              "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    if any(os.environ.get(k) != v for k, v in STEADY_ENV.items()):
        sys.stdout.flush()
        os.execve(sys.executable,
                  [sys.executable, str(Path(__file__).resolve()),
                   *sys.argv[1:]],
                  {**os.environ, **STEADY_ENV})
    try:
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"the port (src/repro_torch) is not importable: {e}",
              file=sys.stderr)
        sys.exit(2)
    from portbench.harness import main

    sys.exit(main())
