"""The comparison's control on the card: the plain reference put in the
program's place and computed in bfloat16, the precision below the
configuration's float32, against the float32 reference, at a cell's own
size.  Its readings set the upper end of the ``result_gap`` limit; the
benchmark's own runs never run it.

    python3 portbench/control.py --workload NAME --seeds 11 12 13

Prints one line a seed (the largest gap over the call's cells, and how
many cells differ) and a JSON summary as the last line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness, reference

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    _, config, traffic, driver, _ = harness.find(spec, args.workload)
    run = driver.Grid.__new__(driver.Grid)      # the cell's shapes, no program
    readings = []
    for s in args.seeds:
        t0 = time.perf_counter()
        driver.Grid.configure(run, config, traffic, s, "cuda:0")
        g = run._grid(run._seeds(0))            # a run's first call at seed s
        want = reference.run(g, run.dev)
        low = reference.run(g, run.dev, torch.bfloat16)
        gaps = reference.gap({k: v.cpu() for k, v in low.items()}, {k: v.cpu() for k, v in want.items()})
        readings.append(float(gaps.max()))
        print(f"control {args.workload} seed {s} result_gap {readings[-1]!r} cells_differing "
              f"{int((gaps > 0).sum())}/{len(gaps)} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "result_gap": readings,
                      "smallest": min(readings), "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
