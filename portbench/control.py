"""The controls of the benchmark's comparisons: the plain reference put in
the program's place and computed in the precision below the one the
configuration states, fed through the same comparison a run makes.  A
control has to come out as not correct.

- ``mxu_fused`` cells: the clause-violation counts and the class sums
  held in 4-bit two's complement (int4 below the stated int8 operands),
  so class sums past ±7 wrap;
- the time-domain race: the chain delays computed in bfloat16 (below the
  stated float32).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

prints, per seed, the numbers compared and their limits, on the card at
the cell's own sizes; the benchmark's own runs never run a control.
"""

from __future__ import annotations

import json
import sys
import time


def control(cell, seed: int, device) -> dict:
    """The control's compared numbers for one seed of ``cell``: one
    call's rows (chunk 0 of the cell's pool) computed by the control."""
    from portbench import harness, inputs
    from portbench.entries import bulk
    from portbench.reference import tm as ref
    cfg_j, tr = cell.config, cell.traffic
    gen = inputs.generator(seed, device)
    ta = inputs.tm_state(cfg_j, gen)
    pool = inputs.literal_rows(gen, (tr["pool_chunks"], tr["rows_per_call"]),
                               cfg_j["n_features"])
    lits = pool[0]
    if "pdl" in cfg_j:
        got = ref.infer_race(ta, lits, cfg_j["n_states"], cfg_j["pdl"],
                             precision="bfloat16")
        keys, aux = ("prediction", "class_sums", "latency_ps",
                     "metastable"), bulk.AUX
    else:
        got = ref.infer(ta, lits, cfg_j["n_states"], precision="int4")
        keys, aux = ("prediction", "class_sums"), ()
    buf = {k: v.cpu() for k, v in zip(keys, got)}
    run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=device, t0=0.0)
    return bulk.check(run, ta, [lits], [(0, buf)], aux)


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
