"""Readings for the limits of `correct`: the program's numbers and its
control's over many seeds, or a planted fault's, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... [--fault <name>]
        [--control <precision>]

Each seed runs the cell's set-up and a window of no length (the checked
requests are served past it; a training cell's check iterations are in
its set-up) and prints one JSON line: the seed and every number the
check compares, the control's as "control.<name>" (with --fault, the
program's with that fault planted). --control reads another precision
of the reference than the configuration's control (the training
reference's "decoder_bf16"). Not part of a benchmark run."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.faults import FAULTS  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None, choices=FAULTS)
    p.add_argument("--control", default=None)
    args = p.parse_args(argv)
    import torch

    from portbench import faults
    from portbench.lib import harness
    from portbench.lib.common import load_named

    cell = harness.find_cell(args.workload)
    config = load_named("configs", cell["config"])
    if args.control is not None:
        config["precision"]["control"] = args.control
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = harness.execute(cell, seed, 0.0, False, torch.device("cuda", 0), t0,
                                config=config,
                                precision="program" if args.fault else "calibrate")
            line = {"seed": seed, "fault": args.fault, "control": args.control,
                    "s": time.perf_counter() - t0}
            line.update({k: c["value"] for k, c in r["checks"].items()})
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    finally:
        if undo is not None:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
