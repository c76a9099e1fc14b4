"""The readings a cell's limits are set from, on the card at the cell's own
size: the program's ``feature_err`` over many seeds (the lower reading),
and the control's (the reference one precision lower, float32 features,
in the program's place) over a few (the upper reading).

    python3 h100_bench/control.py --workload features-4096-resident \
        --seeds 101,102,...,112 --control-seeds 101,102,103 --seconds 2

Every seed is a full run of the cell (set-up, a short window at the cell's
own load, the comparison) in this one process; a control seed also judges
the control on the same inputs. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    run._environment()
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in ((False, True) if seed in ctrl else (False,)):
            r = run.run(args.workload, seed, args.seconds, False, device=args.device,
                        control=control)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
