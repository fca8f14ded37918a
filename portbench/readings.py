"""The readings a cell's limits are set from, on the card, in one process.

    python -m portbench.readings --workload <name> --seeds S [S ...] [--fault NAME]
    python -m portbench.readings --workload <name> --control_seeds S [S ...]

For each of --seeds: the steps or requests that this seed's check compares,
in a window of the check's `window_requests`, run through the program as the
window runs them, and the check's numbers, as `portbench.run` computes them.
With --fault, a fault or the control from the `faults` table of the cell's
runner (portbench/faults.py) is planted under the timed path for them
(`control_tf32`: the runner's plain reference with TF32 products predicting
in the program's place).  --control_seeds is the train
runner's control: the plain reference in TF32 put in the program's place on
the start's steps.  One JSON line a seed on standard output, then the least
and the largest reading of each number.  Set-up is shared, and the window's
timing is not measured here.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from portbench import faults, manifest


def main(argv=None, *, root=manifest.ROOT, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    cell = manifest.load(args.workload, root)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("portbench.readings: no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    kind = cell.traffic["runner"]
    runner = manifest.load_file(root, "runners", kind).Runner(
        root, cell, (args.seeds or args.control_seeds)[0], device)
    runner.setup()
    lo, hi = {}, {}

    def emit(seed, what, got):
        print(json.dumps({"workload": cell.name, "kind": what, "seed": seed, **got,
                          "sample": getattr(runner, "sample_info", {})}), flush=True)
        for k, v in got.items():
            lo[k], hi[k] = min(lo.get(k, v), v), max(hi.get(k, v), v)

    for seed in args.seeds:
        plant = (faults.planted(args.fault, kind, cell.config, root,
                                int(cell.check.get("reference_batch", 1)))
                 if args.fault else contextlib.nullcontext())
        with plant:
            emit(seed, args.fault or "program", runner.readings(seed))
    for seed in args.control_seeds:
        emit(seed, "control_tf32", runner.control(seed, "tf32"))
    print(json.dumps({"workload": cell.name, "least": lo, "largest": hi,
                      "limits": cell.check["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
