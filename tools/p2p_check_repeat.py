"""Phase 36 of ``chip_smoke.py`` (the pix2pixHD train step on the card
against the CPU's, at 64², batch 2, fp32) run again and again, to show how
repeatable its checks are.

    python3 tools/p2p_check_repeat.py [--runs 10] [--no-replay]

By default the phase runs as ``chip_smoke.py`` runs it: the CPU replays the
card's activation patterns (``same_kinks``). With ``--no-replay`` each
device takes its own, and a run fails where an input near a ReLU's kink or
a max pool tie falls on the other side on the card. Prints each
run's verdict (the first failed check, if any), then, for each checked
step, the largest of each held number over the runs.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the held numbers of one "[p2phd train check]" line
FIELDS = {
    "backward": r"largest gradient\) (\{[^}]*\})",
    "first moments": r"Adam first moments (\{[^}]*\})",
    "output after the step": r"after the step ([0-9.e+-]+)",
    "kinks replayed in the step": r"the step with the card's activation "
                                  r"patterns, (\d+) on",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--no-replay", action="store_true",
                    help="each device takes its own activation patterns")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("p2p_check_repeat.py: no CUDA device")
    if args.no_replay:
        @contextlib.contextmanager
        def own_kinks(masks, flips=None):
            yield
            if flips is not None:
                flips.append((0, 0.0))
        cs.same_kinks = own_kinks
    torch.set_grad_enabled(False)
    worst, failed = {}, 0
    for r in range(args.runs):
        t, out = time.time(), io.StringIO()
        verdict = "ok"
        with contextlib.redirect_stdout(out):
            try:
                cs.p2p_train_check(torch.device("cuda"))
            except RuntimeError as exc:
                verdict, failed = f"FAILED: {exc}", failed + 1
        print(f"run {r}: {verdict} ({time.time() - t:.1f} s)", flush=True)
        for line in out.getvalue().splitlines():
            m = re.match(r"\[p2phd train check\] (.*?), 64", line)
            if not m:
                continue
            for name, pat in FIELDS.items():
                v = eval(re.search(pat, line).group(1))
                v = max(v.values()) if isinstance(v, dict) else v
                key = (m.group(1), name)
                worst[key] = max(worst.get(key, v), v)
    for (step, name), v in worst.items():
        print(f"[repeat] {step}: {name}, the largest over the runs {v!r}")
    print(f"[repeat] {failed} of {args.runs} runs failed "
          f"({'no replay' if args.no_replay else 'replayed'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
