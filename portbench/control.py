"""The readings that a cell's limits are set from, several seeds in one
process (the benchmark's own runs never run this):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 8] [--what both]

For each seed it prints one JSON line with the compared numbers of

* ``program``: set-up, a window of ``--seconds`` and the check, as a run of
  ``run.py`` makes them (the lower readings);
* ``control``: the reference put in the program's place in a lower
  precision (the driver's ``control``: TF32 for the products and
  convolutions of a float32 configuration with TF32 off), held against the
  reference by the same comparison (the upper readings); for a live cell
  over as many frames as the program's window held.

A cell held out in ``parked.json`` runs here as one of ``BENCHMARK.json``.
"""

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(prog="portbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--what", choices=("program", "control", "both"), default="both")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench/control.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(ROOT, harness.load_bench(ROOT, parked=True), args.workload)
    driver = harness.load_driver(cell.traffic["kind"])
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed}
        t0 = time.perf_counter()
        run = driver.Run(cell, seed, device)
        run.setup()
        frames = None
        if args.what in ("program", "both"):
            run.window(args.seconds)
            line["attempted"], line["failed"] = run.attempted, run.failed
            line["info"] = {**run.info(), **run.end_to_end()}
            frames = run.attempted
            run.release()
            line["program"] = run.check()
            line["correct"] = harness.decide(line["program"], cell.limits)[0]
        if args.what in ("control", "both"):
            line["control"] = run.control(frames or 300)
            line["control_correct"] = {k: harness.decide(v, cell.limits)[0]
                                       for k, v in line["control"].items()}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
