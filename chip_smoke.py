#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``cistar_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script catches nothing):

1. the device: ``torch.cuda.get_device_name`` and the card's name and power
   limit from ``nvidia-smi``;
2. build the CUDA kernels from ``cistar_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once, sm_90a).

The ResNet path (slice 1): the CycleGAN ResNet-9 generator, 64 features,
256², random weights from seed 0.

3. K1 / K2 on the trunk activation of the main path's own batch,
   (8, 32, 32, 512): the int32 accumulators of the int8 reflect conv equal
   the plain version bit for bit; K1 (bf16 carrier) and K2 (int8 carrier)
   agree with their plain PyTorch versions within ``K1_*`` / ``K2_*``;
4. the path at batch 8: the bf16 forward and the int8 engine with both
   carriers, with the launch counters set to 0 just before and read just
   after. Fidelity, here and at the configuration where the JAX package set
   its 0.1 int8-engine budget (``tools/kernel_matrix.py``'s
   resnet_engine_e2e: 3 blocks, 32 features, 128², batch 32): each int8
   engine about as far from the fp32 forward as the same engine with the
   plain versions of its kernels on the same card (the JAX package's int8
   math, which the CPU tests hold to the JAX emulation) — mean-abs within
   ``KERNEL_MEAN_RATIO`` times, max-abs within ``KERNEL_MAX_EXCESS`` more;
   the distance to the 0.1 budget is printed;
5. serve three requests of (A, B) through ``CycleGANInference("p2p")``;
6. times with CUDA events: img/s of each engine at batch 64, and K1 / K2
   per launch beside their bound and their plain versions.

The bilinear path (slice 2): ``bilinear_content``, the JAX engine's
default generator (``MultiscaleBilinearGenerator``), 16 features, 6 atrous
residual blocks, 512², random weights from seed 0.

7. K5 / K6 on the main path's own activations at batch 4: the int32
   accumulators of the int8 dilated conv equal the plain version bit for
   bit at every rate, at K5's trunk shape (4, 64, 64, 128), at K6's stage
   shape (4, 64, 64, 64→128) and at the 256² stage-1 shape
   (4, 64, 64, 32→64); K5 and K6 agree with their plain versions within
   ``K5_*`` / ``K6_*``; their distance to the JAX package's family budgets
   vs the fp32 modules is printed;
8. the path at batch 4: the bf16 forward and the int8 engine, counted: one
   generator call launches K5 6 times, K6 once (the JAX engine's routing
   rule sends only stage 2 to int8 at 512²), K1 / K2 never. Fidelity as in
   phase 4, against the same engine with plain K5 / K6;
9. serve three requests through ``CycleGANInference("bilinear_content")``;
10. times with CUDA events at batch 32, the JAX suite's
    ``bilinear512_int8`` shape: img/s of each engine, one profile each,
    each engine's time by segment (stem, the three encoder stages, the
    trunk, decoder + head), and K5 / K6 per launch beside their bound and
    their plain versions.

The fp32 reference forwards run with TF32 off, the rest under PyTorch's
defaults. The line before the last is the card's name and power limit; the
kernels' JSON line comes before it; the last line is
``{"ok": true, "device": ...}``. Exits non-zero, printing no result,
without CUDA or without the package beside it.
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

# bilinear_content as the JAX engine and CLI default it; the checked batch
# and the JAX suite's bilinear512_int8 batch (benchmarks/run_suite.py)
BIL = dict(features=16, blocks=6, size=512, batch=4)
BIL_BENCH_BATCH = 32
RATES, RATES2 = (2, 4, 6, 8), (1, 2, 3, 4)
# The JAX package's family budgets, max-abs of one int8 block vs its fp32
# module (benchmarks/kernel_matrix_r5.json): printed, as the 0.1 above.
ATROUS_BUDGET, STAGE_BUDGET = 0.25, 0.35
# K5 vs its plain version, bf16 carrier: as K1 — one bf16 ulp of the value
# plus 0.01 for an LSB flip of the requantized branch sum (atomics order).
K5_REL, K5_ABS = 2.0 ** -7, 0.01
# K6 vs its plain version: no requantization, so only the order of the
# fp32 IN sums differs (~1e-7 relative), which can move a bf16 output by
# one ulp; 1e-4 absolute covers the values near 0, where 2^-7 of the value
# is less than that order effect.
K6_REL, K6_ABS = 2.0 ** -7, 1e-4

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


def print_times(label: str, batch: int, fn) -> None:
    """img/s over 5 calls, then one profiled call."""
    ms = cuda_ms(fn, 5)
    print(f"[times] {label} batch {batch}: {ms!r} ms, "
          f"{batch / ms * 1e3!r} img/s", flush=True)
    wall, busy, top = profile_top(fn)
    print(f"[profile] {label} batch {batch}: wall {wall!r} ms, device busy "
          f"{busy!r} ms; top device time (ms): "
          + "; ".join(f"{k[:48]} {t!r}" for t, k in top), flush=True)


def bound(ops: float, nbytes: float) -> tuple:
    """(least ms, what bounds it) for ``ops`` int8 operations moving
    ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k_bound_ms(n: int, h: int, w: int, c: int, carrier_bytes: int) -> tuple:
    """Least time of one int8 residual block (K1 / K2) on the card: two 3×3
    convs of int8 operations against carrier in + out and both int8
    weights."""
    return bound(2 * 2 * n * h * w * 9 * c * c,
                 2 * n * h * w * c * carrier_bytes + 2 * 9 * c * c + 4 * c * 4)


def k5_bound_ms(n: int, h: int, w: int, c: int, carrier_bytes: int) -> tuple:
    """K5: five 3×3 convs against carrier in + out and five int8 weights."""
    return bound(5 * 2 * n * h * w * 9 * c * c,
                 2 * n * h * w * c * carrier_bytes + 5 * 9 * c * c
                 + 10 * c * 4)


def k6_bound_ms(n: int, h: int, w: int, cin: int, cout: int,
                carrier_bytes: int) -> tuple:
    """K6 at (n, h, w) output pixels: four 3×3 convs against the even
    pixels of the input (all it reads), the output and four int8
    weights."""
    return bound(4 * 2 * n * h * w * 9 * cin * cout,
                 n * h * w * (cin + cout) * carrier_bytes
                 + 4 * 9 * cin * cout + 8 * cout * 4)


def resnet_path(dev, images, counters) -> list:
    """Phases 3-6; the kernels' JSON rows of K1 and K2."""
    import torch

    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import seeded_generator
    from cistar_tpu_torch.ops import quant_int8 as qi

    int8_engine = fi.resnet_generator_int8_trunk_apply
    gen = seeded_generator("p2p", BLOCKS, FEATURES, seed=0, device=dev)
    qblocks = qi.quantize_resnet_trunk(gen)

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

    x = images(BATCH, SIZE)

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
    for m in counters:
        m.reset_launches()
    y_bf16 = gen(x.bfloat16()).float()
    y_k1 = int8_engine(gen, qblocks, x.bfloat16(), "bf16").float()
    y_k2 = int8_engine(gen, qblocks, x.bfloat16(), "int8").float()
    torch.cuda.synchronize()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    print(f"[resnet path] launches {launches}", flush=True)
    check(launches["resblock_int8_bf16io"] == BLOCKS,
          f"{BLOCKS} K1 launches per generator call")
    check(launches["resblock_int8"] == BLOCKS,
          f"{BLOCKS} K2 launches per generator call")
    check(launches["atrous_resblock_int8"] == 0
          and launches["multi_atrous_stage_int8"] == 0,
          "no K5 / K6 launch on the ResNet path")

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

    y_fp32 = fidelity("resnet path", gen, qblocks, x,
                      {"bf16": y_k1, "int8": y_k2})
    for name, y in (("bf16", y_bf16), ("int8/K1", y_k1), ("int8/K2", y_k2)):
        check(tuple(y.shape) == (BATCH, SIZE, SIZE, 1)
              and bool(torch.isfinite(y).all()), f"{name} output shape/finite")
        d = (y - y_fp32).abs()
        print(f"[resnet path] {name} vs fp32: max {d.max().item()!r} mean "
              f"{d.mean().item()!r}", flush=True)
    cfg = BUDGET_CFG
    g_b = seeded_generator("p2p", cfg["blocks"], cfg["features"], seed=0,
                           device=dev)
    q_b = qi.quantize_resnet_trunk(g_b)
    x_b = images(cfg["batch"], cfg["size"])
    fidelity(f"budget config {cfg}", g_b, q_b, x_b,
             {c: int8_engine(g_b, q_b, x_b.bfloat16(), c).float()
              for c in ("bf16", "int8")})

    # 5. serve three requests
    serve(CycleGANInference("p2p", in_features=FEATURES,
                            n_residual_blocks=BLOCKS, seed=1),
          images, BATCH, SIZE, "resnet")

    # 6. times
    xb = images(BENCH_BATCH, SIZE).bfloat16()
    for name, fn in (
            ("bf16", lambda: gen(xb)),
            ("int8/K1", lambda: int8_engine(gen, qblocks, xb, "bf16")),
            ("int8/K2", lambda: int8_engine(gen, qblocks, xb, "int8"))):
        print_times(f"resnet generator {name}", BENCH_BATCH, fn)

    rows = []
    for name, replaces, kfn, pfn, cb, err in (
            ("resblock_int8_bf16io",
             "cistar_tpu/ops/quant_pallas.py:240",
             lambda: kr.resblock_int8_bf16io(h, q0, qi.EPS),
             lambda: qi.resblock_int8_bf16io_plain(h, q0), 2, k1_err),
            ("resblock_int8", "cistar_tpu/ops/quant_pallas.py:181",
             lambda: kr.resblock_int8(hq, hs, q0, qi.EPS),
             lambda: qi.resblock_int8_plain(hq, hs, q0), 1, k2_err)):
        bnd, by = k_bound_ms(n, hh, ww, c, cb)
        ms, plain_ms = cuda_ms(kfn, 20), cuda_ms(pfn, 5)
        rows.append({"name": name, "route": "cuda",
                     "source": "cistar_tpu_torch/csrc/int8_resblock.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": None})
    hb = fi.resnet_encode(gen, images(BENCH_BATCH, SIZE).bfloat16()).contiguous()
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
            bnd, by = k_bound_ms(*hb.shape, cb)
            print(f"[times] {name} {tuple(hb.shape)}: {ms!r} ms, bound "
                  f"{bnd!r} ms ({by})", flush=True)
    return rows


def serve(eng, images, batch: int, size: int, label: str) -> None:
    """Three requests of (A, B) through ``infer_step`` and
    ``infer_step_int8``, each output checked."""
    import torch

    q_a2b, q_b2a = eng.quantize_generators()
    for r in range(3):
        a, b = images(batch, size), images(batch, size)
        t0 = time.perf_counter()
        outs = eng.infer_step(a, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs8 = eng.infer_step_int8(q_a2b, q_b2a, (a, b))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for o in (*outs, *outs8):
            check(tuple(o.shape) == (batch, size, size, 1)
                  and o.dtype == torch.float32
                  and bool(torch.isfinite(o).all()), f"{label} served output")
        gap = [round((p - q).abs().max().item(), 4)
               for p, q in zip(outs, outs8)]
        print(f"[serve {label}] request {r}: infer_step {1e3 * (t1 - t0):.3f} "
              f"ms, infer_step_int8 {1e3 * (t2 - t1):.3f} ms, max|int8-bf16| "
              f"of fake_B, fake_A, recover_B {gap}", flush=True)


def bilinear_path(dev, images, counters) -> list:
    """Phases 7-10; the kernels' JSON rows of K5 and K6."""
    import torch

    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    from cistar_tpu_torch.kernels import int8_atrous as ka
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import seeded_generator
    from cistar_tpu_torch.ops import nn as tnn
    from cistar_tpu_torch.ops import quant_int8 as qi

    int8_engine = fi.bilinear_generator_int8_trunk_apply
    gen = seeded_generator("bilinear_content", BIL["blocks"], BIL["features"],
                           seed=0, device=dev)
    qt = fi.quantize_bilinear_trunk(gen)
    size, n = BIL["size"], BIL["batch"]

    def encode(x, stage_int8):
        """Stem and encoder as the int8 engine runs them, with
        ``stage_int8`` for the stages its routing rule sends to int8:
        (stage inputs, stage outputs)."""
        h = tnn.relu(tnn.instance_norm(gen.init_conv(x)))
        ins, outs = [], []
        for stage, q in zip(gen.down, qt["enc"]):
            ins.append(h)
            h = stage_int8(h, q) if fi.stage_kernel_fits(h, q) else stage(h)
            outs.append(h)
        return ins, outs

    def plain_engine(x):
        """The int8 engine with the plain versions of K5 / K6."""
        _, skips = encode(x, lambda h, q: qi.multi_atrous_stage_int8_plain(
            h[:, ::2, ::2], q, RATES2))
        h = skips[-1]
        for q in qt["res"]:
            h = qi.atrous_resblock_int8_plain(h, q)
        return fi.bilinear_decode(gen, h, skips)

    x = images(n, size)
    xb = x.bfloat16()

    # 7. kernels on the main path's own activations
    ins, outs = encode(xb, qi.multi_atrous_stage_int8)
    x6, h5 = ins[2].contiguous(), outs[2].contiguous()
    check(tuple(x6.shape) == (n, 128, 128, 64)
          and tuple(h5.shape) == (n, 64, 64, 128),
          f"stage-2 input {tuple(x6.shape)}, trunk {tuple(h5.shape)}")
    q5, q6 = qt["res"][0], qt["enc"][2]
    ins256, _ = encode(images(n, 256).bfloat16(), qi.multi_atrous_stage_int8)
    for label, xin, q, rates in (
            ("K5 trunk", h5, q5, RATES),
            ("K6 stage 2", x6[:, ::2, ::2], q6, RATES2),
            ("256² stage 1", ins256[1][:, ::2, ::2], qt["enc"][1], RATES2)):
        xq, _ = qi.quantize_act(xin.contiguous())
        for bi, r in enumerate(rates):
            acc_k = ka.conv3x3_dilated_s8(xq, q["wbk"][bi], r)
            acc_p = qi.conv3x3_dilated_s8_plain(xq, q["wbq"][bi], r)
            check(torch.equal(acc_k, acc_p),
                  f"conv3x3_dilated_s8 {label} rate {r} bit-exact")
        print(f"[kernels] conv3x3_dilated_s8 {label} {tuple(xq.shape)} -> "
              f"{q['wbq'].shape[-1]}, rates {rates}: int32 accumulators "
              f"bit-exact vs plain", flush=True)

    y5k = ka.atrous_resblock_int8(h5, q5, RATES, qi.EPS)
    y5p = qi.atrous_resblock_int8_plain(h5, q5)
    d5 = (y5k.float() - y5p.float()).abs()
    k5_err = d5.max().item()
    k5_over = (d5 - K5_REL * y5p.float().abs()).max().item()
    y6k = ka.multi_atrous_stage_int8(x6, q6, RATES2, qi.EPS)
    y6p = qi.multi_atrous_stage_int8_plain(x6[:, ::2, ::2], q6, RATES2)
    d6 = (y6k.float() - y6p.float()).abs()
    k6_err = d6.max().item()
    k6_over = (d6 - K6_REL * y6p.float().abs()).max().item()
    with fp32_exact():
        f5 = (y5k.float() - gen.res[0](h5.float())).abs().max().item()
        f6 = (y6k.float() - gen.down[2](x6.float())).abs().max().item()
    print(f"[kernels] K5 atrous_resblock_int8 {tuple(h5.shape)} bf16: "
          f"max|kernel-plain| {k5_err!r}, max over one ulp {k5_over!r} (tol "
          f"{K5_ABS}); vs the fp32 block {f5!r}, {ATROUS_BUDGET} budget "
          f"{'met' if f5 <= ATROUS_BUDGET else 'missed'}", flush=True)
    print(f"[kernels] K6 multi_atrous_stage_int8 {tuple(x6.shape)} -> "
          f"{tuple(y6k.shape)} bf16: max|kernel-plain| {k6_err!r}, max over "
          f"one ulp {k6_over!r} (tol {K6_ABS}); vs the fp32 stage {f6!r}, "
          f"{STAGE_BUDGET} budget "
          f"{'met' if f6 <= STAGE_BUDGET else 'missed'}", flush=True)
    check(k5_over <= K5_ABS, "K5 within one bf16 ulp + 0.01 of plain")
    check(k6_over <= K6_ABS, "K6 within one bf16 ulp + 1e-4 of plain")

    # 8. the main path, counted
    for m in counters:
        m.reset_launches()
    y_bf16 = gen(xb).float()
    y_int8 = int8_engine(gen, qt, xb).float()
    torch.cuda.synchronize()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    print(f"[bilinear path] launches {launches}", flush=True)
    check(launches["atrous_resblock_int8"] == BIL["blocks"],
          f"{BIL['blocks']} K5 launches per generator call")
    check(launches["multi_atrous_stage_int8"] == 1,
          "1 K6 launch per generator call at 512²")
    check(launches["resblock_int8_bf16io"] == 0
          and launches["resblock_int8"] == 0,
          "no K1 / K2 launch on the bilinear path")

    with fp32_exact():
        y32 = gen(x)
    dk, dp = (y_int8 - y32).abs(), (plain_engine(xb).float() - y32).abs()
    (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item()) for d in (dk, dp))
    print(f"[bilinear path] int8 engine vs fp32: max {mk!r} mean {ak!r}; "
          f"with plain K5 / K6 max {mp!r} mean {ap!r}", flush=True)
    check(ak <= KERNEL_MEAN_RATIO * ap and mk <= mp + KERNEL_MAX_EXCESS,
          "bilinear path: kernels add little to the plain error")
    for name, y in (("bf16", y_bf16), ("int8", y_int8)):
        check(tuple(y.shape) == (n, size, size, 1)
              and bool(torch.isfinite(y).all()), f"{name} output shape/finite")
        d = (y - y32).abs()
        print(f"[bilinear path] {name} vs fp32: max {d.max().item()!r} mean "
              f"{d.mean().item()!r}", flush=True)

    # 9. serve three requests
    serve(CycleGANInference("bilinear_content", in_features=BIL["features"],
                            n_residual_blocks=BIL["blocks"], seed=1),
          images, n, size, "bilinear")

    # 10. times
    xbb = images(BIL_BENCH_BATCH, size).bfloat16()
    for name, fn in (("bf16", lambda: gen(xbb)),
                     ("int8", lambda: int8_engine(gen, qt, xbb))):
        print_times(f"bilinear generator {name}", BIL_BENCH_BATCH, fn)

    rows = []
    for name, replaces, kfn, pfn, err, (bnd, by) in (
            ("atrous_resblock_int8", "cistar_tpu/ops/quant_pallas.py:973",
             lambda: ka.atrous_resblock_int8(h5, q5, RATES, qi.EPS),
             lambda: qi.atrous_resblock_int8_plain(h5, q5), k5_err,
             k5_bound_ms(*h5.shape, 2)),
            ("multi_atrous_stage_int8", "cistar_tpu/ops/quant_pallas.py:1160",
             lambda: ka.multi_atrous_stage_int8(x6, q6, RATES2, qi.EPS),
             lambda: qi.multi_atrous_stage_int8_plain(x6[:, ::2, ::2], q6,
                                                      RATES2), k6_err,
             k6_bound_ms(*y6k.shape[:3], x6.shape[-1], y6k.shape[-1], 2))):
        ms, plain_ms = cuda_ms(kfn, 20), cuda_ms(pfn, 5)
        rows.append({"name": name, "route": "cuda",
                     "source": "cistar_tpu_torch/csrc/int8_atrous.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": None})
        print(f"[times] {name} at the checked shape: {ms!r} ms, bound {bnd!r} "
              f"ms ({by}), plain {plain_ms!r} ms", flush=True)
    ins_b, outs_b = encode(xbb, qi.multi_atrous_stage_int8)
    x6b, h5b = ins_b[2].contiguous(), outs_b[2].contiguous()
    breakdown(gen, qt, xbb, ins_b, outs_b)
    x6bq, _ = qi.quantize_act(x6b[:, ::2, ::2].contiguous())
    for name, fn, (bnd, by) in (
            ("atrous_resblock_int8 " + str(tuple(h5b.shape)),
             lambda: ka.atrous_resblock_int8(h5b, q5, RATES, qi.EPS),
             k5_bound_ms(*h5b.shape, 2)),
            ("multi_atrous_stage_int8 " + str(tuple(x6b.shape)),
             lambda: ka.multi_atrous_stage_int8(x6b, q6, RATES2, qi.EPS),
             k6_bound_ms(*h5b.shape[:3], x6b.shape[-1], h5b.shape[-1], 2)),
            ("conv3x3_dilated_s8 " + str(tuple(x6bq.shape)) + " -> 128",
             lambda: ka.conv3x3_dilated_s8(x6bq, q6["wbk"][0], 1),
             bound(2 * x6bq.numel() * 9 * 128,
                   x6bq.numel() * (1 + 4 * 128 // 64) + 9 * 64 * 128))):
        ms = cuda_ms(fn, 10)
        print(f"[times] {name}: {ms!r} ms, bound {bnd!r} ms ({by})",
              flush=True)
    return rows


def breakdown(gen, qt, x, ins, outs) -> None:
    """Where the time of each bilinear engine goes: CUDA-event ms of each
    segment of one generator call on the main path's own activations
    (``ins`` / ``outs``: the encoder stages' inputs and outputs)."""
    import torch

    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import nn as tnn
    from cistar_tpu_torch.ops import quant_int8 as qi

    trunk_in = outs[2].contiguous()
    trunk_out = qi.atrous_resblock_chain_int8(trunk_in, qt["res"])

    def bf16_trunk():
        h = trunk_in
        for m in gen.res:
            h = m(h)
        return h

    def bf16_decode():
        h = trunk_out
        for m, skip in zip(gen.up, reversed(outs)):
            h = m(torch.cat([h, skip], dim=-1))
        return tnn.tanh(gen.out_conv(h))

    stem = (lambda: tnn.relu(tnn.instance_norm(gen.init_conv(x))),) * 2
    stages = [(lambda i=i: gen.down[i](ins[i]),) * 2 for i in range(2)]
    stage2 = (lambda: gen.down[2](ins[2]),
              lambda: qi.multi_atrous_stage_int8(ins[2], qt["enc"][2]))
    trunk = (bf16_trunk,
             lambda: qi.atrous_resblock_chain_int8(trunk_in, qt["res"]))
    decode = (bf16_decode, lambda: fi.bilinear_decode(gen, trunk_out, outs))
    names = ("stem", "stage 0", "stage 1", "stage 2", "trunk",
             "decoder + head")
    segs = (stem, *stages, stage2, trunk, decode)
    for e, engine in enumerate(("bf16", "int8")):
        ms = [cuda_ms(seg[e], 5) for seg in segs]
        print(f"[breakdown] bilinear {engine} batch {x.shape[0]} (ms): "
              + "; ".join(f"{k} {t!r}" for k, t in zip(names, ms))
              + f"; sum {sum(ms)!r}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device, nothing run")
    sys.path.insert(0, ROOT)
    from cistar_tpu_torch.kernels import build
    from cistar_tpu_torch.kernels import int8_atrous as ka
    from cistar_tpu_torch.kernels import int8_resblock as kr

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

    cpu_gen = torch.Generator().manual_seed(0)

    def images(n: int, size: int) -> torch.Tensor:
        return (torch.rand(n, size, size, 1, generator=cpu_gen) * 2
                - 1).to(dev)

    counters = (kr, ka)
    rows = resnet_path(dev, images, counters)
    rows += bilinear_path(dev, images, counters)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
