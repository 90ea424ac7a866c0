"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the program (``src/repro_torch``), on a machine with the CUDA
devices the cell asks for. Prints the checks on standard error and one
JSON object as the last line of standard output.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = "1"      # one host thread: the loop's CPU work is small
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache")):
        os.environ[var] = str(root / "build" / sub)
    from portbench.harness import main

    sys.exit(main(t_start=T_START))
