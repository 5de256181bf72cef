"""The controls of the benchmark's comparisons: the plain reference put in
the program's place and computed in the precision below the one the
configuration states, fed through the same comparison a run makes.  A
control has to come out as not correct.  Each traffic entry's
``control`` hook computes its control (``portbench/entries/<entry>.py``
says which precision it takes, and where).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

prints, per seed, the numbers compared and their limits, on the card at
the cell's own sizes; the benchmark's own runs never run a control.
"""

from __future__ import annotations

import json
import sys
import time


def control(cell, seed: int, device) -> dict:
    """The control's compared numbers for one seed of ``cell``, each
    ``(value, limit)``, by the hook of the cell's traffic entry."""
    from portbench import spec
    return spec.entry_module(cell.traffic["entry"], cell.root).control(
        cell, seed, device)


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import spec
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the controls run on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in args.workload:
        cell = spec.find_cell(name)
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            got = control(cell, seed, dev)
            failed = any(v > lim for v, lim in got.values())
            print(json.dumps({"workload": name, "seed": seed,
                              "control_failed": failed,
                              "seconds": time.perf_counter() - t,
                              "compared": got}), flush=True)
    return 0


if __name__ == "__main__":
    from pathlib import Path
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main(sys.argv[1:]))
