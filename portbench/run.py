"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device[, breakdown],
checks); the compared numbers and their limits are also the last lines of
standard error.  Exits non-zero, printing no result, without the CUDA
devices the cell asks for or when the run loaded the JAX stack.
"""
import time

STARTED = time.perf_counter()       # set-up counts from here, imports and all

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "portbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    torch.set_num_threads(1)
    from portbench import harness
    sys.exit(harness.main(args, STARTED))
