"""The readings a cell's limits are set from, on the card, in one process:

    python3 -m benchmark.calibrate --workload cornell-pt-1080p \\
        --seeds 11 12 13 --control-seeds 21 22 23 --seconds 2

Each ``--seeds`` seed is a run of the cell as the benchmark makes it
(``run.run_cell``, a window of ``--seconds`` at the cell's own load); each
``--control-seeds`` seed is the control: the reference rounded to
bfloat16 (its scene tables, camera and every uniform) in the program's
place, judged by the same comparison.  One JSON line a run, with the
compared numbers: the sound runs give each limit's lower reading, the
control its upper.  ``limits/<cell>.json`` is set between the two."""
from __future__ import annotations

import argparse
import json
import sys

from .cells import load_cell
from .run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    cell = load_cell(args.workload)
    runs = ([(s, None) for s in args.seeds]
            + [(s, torch.bfloat16) for s in args.control_seeds])
    for seed, ctl in runs:
        out = run_cell(cell, seed, args.seconds, False, args.device,
                       control=ctl)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": ctl is not None,
                          "correct": out["correct"],
                          "frames": out["frames_compared"],
                          "pixels": out["pixels_compared"],
                          "compared": {k: v["value"] for k, v in
                                       out["compared"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
