#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``cistar_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script catches nothing):

1. the device: ``torch.cuda.get_device_name`` and the card's name and power
   limit from ``nvidia-smi``;
2. build the CUDA kernels from ``cistar_tpu_torch/csrc`` (``nvcc``, sm_90a);
3. the kernels at the main path's full width, on the trunk activation of
   the main path's own batch, (8, 32, 32, 512): the int32 accumulators of
   the int8 conv equal the plain version bit for bit; K1 (bf16 carrier) and
   K2 (int8 carrier) agree with their plain PyTorch versions on the card
   within the tolerances stated at ``K1_*`` / ``K2_*``;
4. the main path: the CycleGAN ResNet-9 generator (64 features, 256²,
   batch 8, random weights from seed 0) in bf16, and its int8 engine with
   both carriers, with the launch counters set to 0 just before and read
   just after; the fp32 reference forwards run with TF32 off, the rest
   under PyTorch's defaults. Fidelity, here and at the configuration where
   the JAX package set its 0.1 int8-engine budget
   (``tools/kernel_matrix.py``'s resnet_engine_e2e: 3 blocks, 32 features,
   128², batch 32): each int8 engine about as far from the fp32 forward as
   the same engine with the plain versions of K1/K2 (the JAX package's int8
   math, which the CPU tests hold to the JAX emulation) on the same card —
   mean-abs within ``KERNEL_MEAN_RATIO`` times, max-abs within
   ``KERNEL_MAX_EXCESS`` more; the distance to the 0.1 budget is printed;
5. serve three requests of (A, B) through the inference engine's
   ``infer_step`` and ``infer_step_int8``;
6. times with CUDA events: img/s of each engine at batch 64, and each
   kernel's time per launch beside its bound and its plain version.

The line before the last is the card's name and power limit; the kernels'
JSON line comes before it; the last line is ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without CUDA or without the package
beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH, SIZE, FEATURES, BLOCKS = 8, 256, 64, 9
BENCH_BATCH = 64
# The int8 engine's max-abs budget vs fp32 in the JAX package
# (benchmarks/kernel_matrix_r5.json, resnet_engine_e2e), set on the
# configuration BUDGET_CFG (tools/kernel_matrix.py).
# The int8 math itself misses it at 9 blocks / 64 features, and lands near
# it at BUDGET_CFG with other random weights (PERF.md, Findings), so it is
# printed, not enforced. What is enforced: the kernels add little to the
# error of the plain versions of the same math. They differ from them only
# by LSB flips of the requantized tensors (the kernels sum the IN
# statistics with atomics, in another order), on ~1e-4 of the elements:
# the mean-abs error over the 524,288 outputs barely moves (10% allowed);
# the max-abs error can move by the flips' local effect (0.04 seen, 0.1
# allowed).
E2E_BUDGET, BUDGET_CFG = 0.1, dict(blocks=3, features=32, size=128, batch=32)
KERNEL_MEAN_RATIO, KERNEL_MAX_EXCESS = 1.1, 0.1
# K1 vs its plain version, bf16 carrier, per element: one bf16 ulp of the
# value (at most 2^-7 of it) plus 0.01, the most by which one flipped LSB
# of the requantized intermediate moves an output (4.3e-3 seen with an
# fp32 carrier; the kernel sums the IN statistics with atomics, in another
# order than the plain version).
K1_REL, K1_ABS = 2.0 ** -7, 0.01
# K2 vs its plain version: the same LSB flips, at most one LSB per element
# on at most 0.1% of the elements; the per-image scales to 1e-4 relative.
K2_MAX_LSB, K2_MAX_FRAC, K2_SCALE_RTOL = 1, 1e-3, 1e-4
# Peaks of an H100 SXM (NVIDIA data sheet; dense int8 tensor-core
# operations, HBM bandwidth), for the bound of each kernel.
PEAK_INT8_OPS, PEAK_BYTES = 1979e12, 3.35e12


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the fp32 reference forwards (cuDNN convs default to
    TF32). The engines run under PyTorch's defaults: their convs take bf16
    inputs, which TF32 holds exactly."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after two warm-up calls."""
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


def profile_top(fn, k: int = 8) -> tuple:
    """One profiled call: wall ms, summed device-kernel ms, and the ``k``
    kernels with the most device time as (ms, name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return wall, sum(t for t, _ in rows), rows[:k]


def k_bound_ms(n: int, h: int, w: int, c: int, carrier_bytes: int) -> tuple:
    """Least time of one int8 residual block on the card: two 3×3 convs of
    int8 operations against carrier in + out and both int8 weights."""
    ops = 2 * 2 * n * h * w * 9 * c * c
    nbytes = 2 * n * h * w * c * carrier_bytes + 2 * 9 * c * c + 4 * c * 4
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device, nothing run")
    sys.path.insert(0, ROOT)
    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    from cistar_tpu_torch.kernels import build
    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import build_resnet_generator
    from cistar_tpu_torch.ops import quant_int8 as qi

    int8_engine = fi.resnet_generator_int8_trunk_apply

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {kind} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    print(f"[build] csrc/*.cu -> sm_90a in {build.build_all():.1f} s",
          flush=True)

    gen = build_resnet_generator(BLOCKS, FEATURES, seed=0, device=dev)
    qblocks = qi.quantize_resnet_trunk(gen)
    cpu_gen = torch.Generator().manual_seed(0)

    def images(n: int, size: int = SIZE) -> torch.Tensor:
        return (torch.rand(n, size, size, 1, generator=cpu_gen) * 2
                - 1).to(dev)

    def plain_engine(g, qb, x, carrier):
        """The int8 engine with the plain versions of K1 / K2."""
        h = fi.resnet_encode(g, x)
        if carrier == "bf16":
            for q in qb:
                h = qi.resblock_int8_bf16io_plain(h, q)
        else:
            hq, hs = qi.quantize_act(h)
            for q in qb:
                hq, hs = qi.resblock_int8_plain(hq, hs, q)
            h = (hq.float() * hs[:, :, None, None]).to(h.dtype)
        return fi.resnet_decode(g, h)

    x = images(BATCH)

    # 3. kernels at the main path's width, on its trunk activation
    h = fi.resnet_encode(gen, x.bfloat16()).contiguous()
    n, hh, ww, c = h.shape
    check((n, hh, ww, c) == (BATCH, 32, 32, 512), f"trunk shape {h.shape}")
    q0 = qblocks[0]
    hq, hs = qi.quantize_act(h)
    acc_k = kr.conv3x3_reflect_s8(hq, q0["w1k"])
    acc_p = qi.conv3x3_reflect_s8_plain(hq, q0["w1q"])
    check(torch.equal(acc_k, acc_p), "conv3x3_reflect_s8 int32 accumulators "
          "equal the plain version bit for bit")
    print(f"[kernels] conv3x3_reflect_s8 {tuple(hq.shape)}: int32 "
          f"accumulators bit-exact vs plain", flush=True)

    y1k = kr.resblock_int8_bf16io(h, q0, qi.EPS)
    y1p = qi.resblock_int8_bf16io_plain(h, q0)
    d1 = (y1k.float() - y1p.float()).abs()
    k1_err = d1.max().item()
    k1_over = (d1 - K1_REL * y1p.float().abs()).max().item()
    print(f"[kernels] K1 resblock_int8_bf16io {tuple(h.shape)} bf16: "
          f"max|kernel-plain| {k1_err!r}, max over one ulp {k1_over!r} "
          f"(tol {K1_ABS})", flush=True)
    check(k1_over <= K1_ABS, "K1 within one bf16 ulp + 0.01 of plain")

    (q2k, s2k), (q2p, s2p) = kr.resblock_int8(hq, hs, q0, qi.EPS), \
        qi.resblock_int8_plain(hq, hs, q0)
    dq = (q2k.int() - q2p.int()).abs()
    frac = (dq > 0).float().mean().item()
    s_rel = ((s2k - s2p).abs() / s2p).max().item()
    k2_err = (q2k.float() * s2k[:, :, None, None]
              - q2p.float() * s2p[:, :, None, None]).abs().max().item()
    print(f"[kernels] K2 resblock_int8 {tuple(hq.shape)}: max|dq| "
          f"{dq.max().item()} LSB on {frac!r} of elements, scale rel err "
          f"{s_rel!r}, max|dequant diff| {k2_err!r}", flush=True)
    check(dq.max().item() <= K2_MAX_LSB and frac <= K2_MAX_FRAC
          and s_rel <= K2_SCALE_RTOL, "K2 within tolerance of plain")

    # 4. the main path, counted
    kr.reset_launches()
    y_bf16 = gen(x.bfloat16()).float()
    y_k1 = int8_engine(gen, qblocks, x.bfloat16(), "bf16").float()
    y_k2 = int8_engine(gen, qblocks, x.bfloat16(), "int8").float()
    torch.cuda.synchronize()
    launches = dict(kr.launches)
    print(f"[main path] launches {launches}", flush=True)
    check(launches["resblock_int8_bf16io"] == BLOCKS,
          f"{BLOCKS} K1 launches per generator call")
    check(launches["resblock_int8"] == BLOCKS,
          f"{BLOCKS} K2 launches per generator call")

    def fidelity(label, g, qb, xf, ys):
        """Error vs the fp32 forward of the kernel engines ``ys`` (by
        carrier) and of the same engines with plain blocks."""
        with fp32_exact():
            y32 = g(xf)
        for carrier, y in ys.items():
            dk = (y - y32).abs()
            dp = (plain_engine(g, qb, xf.bfloat16(), carrier).float()
                  - y32).abs()
            (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item())
                                  for d in (dk, dp))
            print(f"[{label}] int8 engine, {carrier} carrier, vs fp32: "
                  f"max {mk!r} mean {ak!r}; with plain blocks max {mp!r} "
                  f"mean {ap!r}; 0.1 budget "
                  f"{'met' if mk <= E2E_BUDGET else 'missed'}", flush=True)
            check(ak <= KERNEL_MEAN_RATIO * ap
                  and mk <= mp + KERNEL_MAX_EXCESS,
                  f"{label} {carrier}: kernels add little to the plain error")
        return y32

    y_fp32 = fidelity("main path", gen, qblocks, x,
                      {"bf16": y_k1, "int8": y_k2})
    for name, y in (("bf16", y_bf16), ("int8/K1", y_k1), ("int8/K2", y_k2)):
        check(tuple(y.shape) == (BATCH, SIZE, SIZE, 1)
              and bool(torch.isfinite(y).all()), f"{name} output shape/finite")
        d = (y - y_fp32).abs()
        print(f"[main path] {name} vs fp32: max {d.max().item()!r} mean "
              f"{d.mean().item()!r}", flush=True)
    cfg = BUDGET_CFG
    g_b = build_resnet_generator(cfg["blocks"], cfg["features"], seed=0,
                                 device=dev)
    q_b = qi.quantize_resnet_trunk(g_b)
    x_b = images(cfg["batch"], cfg["size"])
    fidelity(f"budget config {cfg}", g_b, q_b, x_b,
             {c: int8_engine(g_b, q_b, x_b.bfloat16(), c).float()
              for c in ("bf16", "int8")})

    # 5. serve three requests
    eng = CycleGANInference("p2p", in_features=FEATURES,
                            n_residual_blocks=BLOCKS, seed=1)
    q_a2b, q_b2a = eng.quantize_generators()
    for r in range(3):
        a, b = images(BATCH), images(BATCH)
        t0 = time.perf_counter()
        outs = eng.infer_step(a, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs8 = eng.infer_step_int8(q_a2b, q_b2a, (a, b))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for o in (*outs, *outs8):
            check(tuple(o.shape) == (BATCH, SIZE, SIZE, 1)
                  and o.dtype == torch.float32
                  and bool(torch.isfinite(o).all()), "served output")
        gap = [round((p - q).abs().max().item(), 4)
               for p, q in zip(outs, outs8)]
        print(f"[serve] request {r}: infer_step {1e3 * (t1 - t0):.3f} ms, "
              f"infer_step_int8 {1e3 * (t2 - t1):.3f} ms, max|int8-bf16| "
              f"of fake_B, fake_A, recover_B {gap}", flush=True)

    # 6. times
    xb = images(BENCH_BATCH).bfloat16()
    for name, fn in (
            ("bf16", lambda: gen(xb)),
            ("int8/K1", lambda: int8_engine(gen, qblocks, xb, "bf16")),
            ("int8/K2", lambda: int8_engine(gen, qblocks, xb, "int8"))):
        ms = cuda_ms(fn, 5)
        print(f"[times] generator {name} batch {BENCH_BATCH}: {ms!r} ms, "
              f"{BENCH_BATCH / ms * 1e3!r} img/s", flush=True)
        wall, busy, top = profile_top(fn)
        print(f"[profile] generator {name} batch {BENCH_BATCH}: wall "
              f"{wall!r} ms, device busy {busy!r} ms; top device time (ms): "
              + "; ".join(f"{k[:48]} {t!r}" for t, k in top), flush=True)

    rows = []
    for name, replaces, kfn, pfn, cb, err in (
            ("resblock_int8_bf16io",
             "cistar_tpu/ops/quant_pallas.py:240",
             lambda: kr.resblock_int8_bf16io(h, q0, qi.EPS),
             lambda: qi.resblock_int8_bf16io_plain(h, q0), 2, k1_err),
            ("resblock_int8", "cistar_tpu/ops/quant_pallas.py:181",
             lambda: kr.resblock_int8(hq, hs, q0, qi.EPS),
             lambda: qi.resblock_int8_plain(hq, hs, q0), 1, k2_err)):
        bound, by = k_bound_ms(n, hh, ww, c, cb)
        ms, plain_ms = cuda_ms(kfn, 20), cuda_ms(pfn, 5)
        rows.append({"name": name, "route": "cuda",
                     "source": "cistar_tpu_torch/csrc/int8_resblock.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": None})
    hb = fi.resnet_encode(gen, images(BENCH_BATCH).bfloat16()).contiguous()
    hbq, hbs = qi.quantize_act(hb)
    for name, fn, cb in (
            ("resblock_int8_bf16io",
             lambda: kr.resblock_int8_bf16io(hb, q0, qi.EPS), 2),
            ("resblock_int8",
             lambda: kr.resblock_int8(hbq, hbs, q0, qi.EPS), 1),
            ("conv3x3_reflect_s8",
             lambda: kr.conv3x3_reflect_s8(hbq, q0["w1k"]), None)):
        ms = cuda_ms(fn, 10)
        if cb is None:
            ops = 2 * hb.numel() * 9 * c
            print(f"[times] {name} {tuple(hb.shape)}: {ms!r} ms, "
                  f"{ops / ms * 1e-9!r} TOPS", flush=True)
        else:
            bound, by = k_bound_ms(*hb.shape, cb)
            print(f"[times] {name} {tuple(hb.shape)}: {ms!r} ms, bound "
                  f"{bound!r} ms ({by})", flush=True)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
