"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json (at the root of
the checkout); its configuration, traffic mix, system and metrics are
found by name under portbench/ (README.md there). Set-up builds the
program, makes the weights and inputs from the seed and warms up the
cell's shapes; the window then runs the traffic for `--seconds`; with
`--trace 1` the profiler records the first units of the window and the
per-layer metrics are read from it. Then the plain reference checks what
the window produced, and the last line of standard output is the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program inside the checkout, at fixed
# paths (the K1 / K2 libraries go to cips3dpp_torch/_build/ there)
CACHE = ROOT / "portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.lib import harness
    from portbench.lib.common import forbidden_modules

    try:
        cell = harness.find_cell(args.workload)
    except (FileNotFoundError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 3
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
