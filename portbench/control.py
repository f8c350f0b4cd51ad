"""The controls of the cells' comparisons, on the card: for each seed, the
cell's compared numbers with the plain reference at the control's
precision (the cell file's ``control``) put in the program's place, at
the cell's own sizes. A control has to read above the cell's limits; the
benchmark's own runs do not run it.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    cell, cfg = harness.cell_files(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        ctx = harness.Ctx(cell, cfg, seed, 0.0, False, dev, time.perf_counter())
        got = harness.traffic(cell).control(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell["control"], "numbers": got,
                          "limits": {k: v["limit"]
                                     for k, v in cell["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
