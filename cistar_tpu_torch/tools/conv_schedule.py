"""The schedules of the ``wgmma`` conv that K5 and K7a could take, and K6's
two routes, timed against each other on one card.

    python3 -m cistar_tpu_torch.tools.conv_schedule

Builds ``conv_schedule.cu`` (K5's and K7a's own conv code from
``csrc/int8_atrous.cu`` / ``csrc/wgmma_conv.cuh``, plus entries that launch
it other ways) into the kernel build directory, then times with CUDA
events, in turns (A B … B A), on random int8 inputs from seed 0:

* K5's four dilated branch convs at (4 | 32, 64, 64, 128), rates 2/4/6/8:
  four launches of one block a tile, one launch of one block a tile, and
  one launch of persistent blocks (what ``int8_atrous.cu`` runs);
* one reflect 3×3 conv at K5's shape (its fifth conv, BN 128) and at
  K7a's path shapes (BN of ``wg_bn``, with the max): one block a tile
  (K7a's schedule), persistent blocks (K5's), and one block a tile with the
  shared-memory carveout forced to its most (L1 28 KB), the carveout a
  persistent block's larger shared memory falls into;
* K6 at (4 | 32, 128, 128, 64) bf16 → (·, 64, 64, 128), rates 1/2/3/4, at
  its 64-byte K stage: route 2 (the four branch convs as one launch
  writing each branch's fp32 f_b, then ``branch_sum_kernel``) against
  route 3 (two passes over the same products, f_b kept on chip: what
  ``int8_atrous.cu`` runs).

Every K5 / K7a schedule's fp32 output must equal the first's bit for bit.
K6: route 3's second pass on route 2's statistics must equal route 2's
output bit for bit (the IN sums are atomics, so two full runs may differ
by a bf16 ulp); route 3 run whole must be within one bf16 ulp + 1e-4 of
route 2, chip_smoke's K6 tolerance. Prints the card's name and power
limit, one line a case, then one JSON object. Exits non-zero without a
card. Not part of any path.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().with_suffix(".cu")
RATES = (2, 4, 6, 8)
# K5's trunk at bilinear_content's checked and timed batch; K7a's trunks
# (global ct 256, multiscale / local ct 128) at their checked and timed
# batches
K5_SHAPES = ((4, 64, 64, 128), (32, 64, 64, 128))
K7A_SHAPES = ((4, 32, 32, 1024), (16, 32, 32, 1024), (2, 64, 64, 512),
              (4, 64, 64, 512), (8, 64, 64, 512))
# K6: bilinear_content's stage 2 input (N, 128, 128, 64) → 128 channels at
# the checked and the timed batch; its rates on the subsampled image
K6_SHAPES = ((4, 128, 128, 64, 128), (32, 128, 128, 64, 128))
K6_RATES, K6_EPS = (1, 2, 3, 4), 1e-5
K6_REL, K6_ABS = 2.0 ** -7, 1e-4


def _library():
    from cistar_tpu_torch.kernels import build

    h = hashlib.sha256(SRC.read_bytes())
    for p in sorted(build.CSRC.iterdir()):
        h.update(p.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    so = build.BUILD_DIR / f"libconv_schedule-{h.hexdigest()[:16]}.so"
    if not so.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(".tmp")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(tmp),
                        str(SRC)], check=True, capture_output=True)
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sched_branches.argtypes = [P] * 6 + [I] * 9 + [P]
    lib.sched_conv.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.sched_k6.argtypes = ([P, I, I] + [P] * 4 + [I] * 9
                             + [ctypes.c_float, I, P])
    lib.sched_branches.restype = lib.sched_conv.restype = I
    lib.sched_k6.restype = I
    lib.cistar_atrous_workspace_bytes.argtypes = [I] * 6
    lib.cistar_atrous_workspace_bytes.restype = ctypes.c_size_t
    return lib


def _ms(fn, iters: int = 30) -> float:
    import torch

    fn()
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def _run_all(label: str, runs: dict) -> None:
    import torch

    for k, run in runs.items():
        err = run()
        if err:
            raise RuntimeError(f"{label} {k}: CUDA error {err}")
    torch.cuda.synchronize()


def _time_in_turns(label: str, runs: dict) -> dict:
    """ms per launch of each run, timed in turns (A B … B A), two readings
    each."""
    names = list(runs)
    res = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            res[k].append(_ms(runs[k]))
    print(f"[schedule] {label}: " + "; ".join(
        f"{k} {v!r}" for k, v in res.items()), flush=True)
    return res


def _compare(label: str, runs: dict, outs: dict) -> dict:
    """Run each schedule once, check every output equals the first's, then
    time them in turns."""
    import torch

    _run_all(label, runs)
    first = next(iter(outs.values()))
    if not all(torch.equal(first, o) for o in outs.values()):
        raise RuntimeError(f"{label}: the schedules' outputs differ")
    return _time_in_turns(label, runs)


def _k6_case(lib, shape, s8, g, dev, stream, card: str) -> dict:
    """K6's route 2 against route 3 at ``shape`` (N, H, W, Cin, Cout) of
    the full-resolution input: outputs compared (see the module doc), then
    both timed in turns."""
    import torch

    n, hin, win, cin, cout = shape
    h, w = (hin + 1) // 2, (win + 1) // 2
    x = torch.randn(n, hin, win, cin, generator=g).to(dev, torch.bfloat16)
    wbk = s8(4, cout, 9 * cin)
    sb = torch.empty(8, cout)
    sb[0::2] = torch.rand(4, cout, generator=g) * 1e-3   # weight scales
    sb[1::2] = torch.randn(4, cout, generator=g) * 0.01  # biases
    sb = sb.to(dev)
    nbytes = lib.cistar_atrous_workspace_bytes(n, h, w, cin, cout, 0)
    wss = [torch.empty(nbytes, dtype=torch.uint8, device=dev) for _ in range(2)]
    outs = [torch.empty(n, h, w, cout, dtype=torch.bfloat16, device=dev)
            for _ in range(3)]

    def run(mode, ws, out):
        return lambda: lib.sched_k6(
            x.data_ptr(), hin, win, wbk.data_ptr(), sb.data_ptr(),
            out.data_ptr(), ws.data_ptr(), n, h, w, cin, cout, *K6_RATES,
            K6_EPS, mode, stream())

    label = f"K6 {shape[:4]} -> {cout} on {card}"
    route2, route3 = run(0, wss[0], outs[0]), run(1, wss[1], outs[1])
    _run_all(label, {"route 2": route2, "route 3": route3,
                     "route 3 pass B on route 2's statistics":
                     run(2, wss[0], outs[2])})
    if not torch.equal(outs[0], outs[2]):
        raise RuntimeError(f"{label}: route 3's pass B on route 2's "
                           "statistics differs from route 2")
    ref = outs[0].float()
    over = ((outs[1].float() - ref).abs() - K6_REL * ref.abs()).max().item()
    print(f"[schedule] {label}: route 3's pass B on route 2's statistics "
          f"equals route 2 bit for bit; route 3 whole vs route 2: max over "
          f"one bf16 ulp {over!r} (tol {K6_ABS})", flush=True)
    if over > K6_ABS:
        raise RuntimeError(f"{label}: route 3 differs from route 2")
    return _time_in_turns(label, {"route 2 (f_b through memory)": route2,
                                  "route 3 (f_b on chip)": route3})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("conv_schedule: no CUDA device, nothing run")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    lib = _library()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    out = {}
    for n, h, w, c in K5_SHAPES:
        q, wbk = s8(n, h, w, c), s8(4 * c, 9 * c)
        sb = torch.rand(8, c, generator=g).to(dev)
        xs = torch.full((n,), 0.01, device=dev)
        st = torch.empty(8 * n * c, device=dev)
        modes = {"four launches": 0, "one launch": 1, "one launch, persistent": 2}
        fs = {k: torch.empty(4, n, h, w, c, device=dev) for k in modes}
        runs = {k: (lambda m=m, f=fs[k]: lib.sched_branches(
            q.data_ptr(), wbk.data_ptr(), sb.data_ptr(), xs.data_ptr(),
            f.data_ptr(), st.data_ptr(), n, h, w, c, *RATES, m, stream()))
            for k, m in modes.items()}
        out[f"K5 branches {(n, h, w, c)}"] = _compare(
            f"K5's four branch convs {(n, h, w, c)}", runs, fs)
    for shape, want_max in ([(s, 0) for s in K5_SHAPES]
                            + [(s, 1) for s in K7A_SHAPES]):
        n, h, w, c = shape
        xp, wk = s8(n, h + 2, w + 2, c), s8(c, 9 * c)
        sb = torch.rand(2, c, generator=g).to(dev)
        xs = torch.full((n,), 0.01, device=dev)
        st = torch.empty(3 * n * c, device=dev)
        modes = {"one block a tile": 0, "persistent": 1,
                 "one block a tile, carveout at most": 2}
        fs = {k: torch.empty(n, h, w, c, device=dev) for k in modes}
        runs = {k: (lambda m=m, f=fs[k]: lib.sched_conv(
            xp.data_ptr(), wk.data_ptr(), xs.data_ptr(), sb.data_ptr(),
            f.data_ptr(), st.data_ptr(), n, h, w, c, want_max, m, stream()))
            for k, m in modes.items()}
        what = "K7a's conv" if want_max else "K5's reflect conv"
        out[f"{what} {shape}"] = _compare(f"{what} {shape}", runs, fs)
    for shape in K6_SHAPES:
        out[f"K6 {shape}"] = _k6_case(lib, shape, s8, g, dev, stream, smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
