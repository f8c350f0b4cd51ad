"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output,
and each compared number beside its limit on the last lines of standard
error. Exits non-zero without a result where there is no card, where the
cell asks for more cards than there are, or where a module of JAX or of
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# Build and kernel caches at fixed places inside the checkout, so that a
# cell's later runs find what its first run built.
_CACHE = ROOT / "portbench" / ".cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", str(_CACHE / "nv"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    cell, _ = harness.cell_files(args.workload)
    import torch
    torch.set_num_threads(2)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {count}", file=sys.stderr)
        return 3
    result, out = harness.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    for line in out.notes:
        print(line, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
