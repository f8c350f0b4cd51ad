"""The counting functions reproduce PERF.md's kernel-table bounds and the
configurations' FLOPs."""

import json

import pytest

from _portbench_small import ROOT
from portbench.counts import (k7, k8, p2phd_global_512, p2phd_r2l_msrb7_512,
                              peaks, pix2pixhd_d)


def cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_k8_bound_matches_the_kernel_table():
    # PERF.md: 0.2214 ms a launch (mean of a block's four) at batch 8
    b = k8.block_bounds_s(8, 64, 64, 512)
    assert len(b) == 4
    assert sum(b) / 4 * 1e3 == pytest.approx(0.2214, abs=5e-5)
    # and 0.0553 at the checked batch 2, 0.0277 at batch 1
    assert sum(k8.block_bounds_s(2, 64, 64, 512)) / 4 * 1e3 == \
        pytest.approx(0.0553, abs=5e-5)
    assert sum(k8.block_bounds_s(1, 64, 64, 512)) / 4 * 1e3 == \
        pytest.approx(0.0277, abs=5e-5)


@pytest.mark.parametrize("half", ["a", "b"])
def test_k7_bound_matches_the_kernel_table(half):
    assert k7.half_bound_s(16, 32, 32, 1024, half) * 1e3 == \
        pytest.approx(0.1563, abs=5e-5)
    assert k7.half_bound_s(4, 32, 32, 1024, half) * 1e3 == \
        pytest.approx(0.0391, abs=5e-5)


def test_kernel_bounds_of_the_configurations():
    # each cell's per-launch bounds: K8 at batch 8, K7a / K7b at batch 16
    u = p2phd_r2l_msrb7_512.kernel_bounds(cfg("p2phd_r2l_msrb7_512"), 8)
    assert u["msrb_branch_int8"] * 1e3 == pytest.approx(0.2214, abs=5e-5)
    g = p2phd_global_512.kernel_bounds(cfg("p2phd_global_512"), 16)
    assert set(g) == {"resblock_int8_tiled_a", "resblock_int8_tiled_b"}
    for v in g.values():
        assert v * 1e3 == pytest.approx(0.1563, abs=5e-5)


def test_roofline_reader_sums_launches_over_device_time():
    from portbench.trace import roofline_percent
    g = cfg("p2phd_global_512")
    per = p2phd_global_512.kernel_bounds(g, 16)
    tr = {"op_calls": {"resblock_int8_tiled_a": 9,
                       "resblock_int8_tiled_b": 9},
          "op_device_s": {"resblock_int8_tiled_a": 9 * 0.33e-3,
                          "resblock_int8_tiled_b": 9 * 0.38e-3}}
    rec = {"trace": tr, "cfg": g, "batch": 16, "counts": p2phd_global_512}
    got = roofline_percent(rec, tuple(per))
    assert got == pytest.approx(100 * sum(per.values()) / 0.71e-3)
    assert roofline_percent(rec, ("msrb_branch_int8",)) is None


def test_generator_flops():
    u, g = cfg("p2phd_r2l_msrb7_512"), cfg("p2phd_global_512")
    fu = sum(f for f, _ in p2phd_r2l_msrb7_512.generator_convs(u, 1, True))
    fg = sum(f for f, _ in p2phd_global_512.generator_convs(g, 1, True))
    assert fu / 1e9 == pytest.approx(889.1, abs=0.1)
    assert fg / 1e9 == pytest.approx(428.5, abs=0.1)
    # the quantised trunks: 3 MSRB blocks' branch convs, 18 resnet convs
    tu = sum(f for f, dt in p2phd_r2l_msrb7_512.generator_convs(u, 1, True)
             if dt == "int8")
    tg = sum(f for f, dt in p2phd_global_512.generator_convs(g, 1, True)
             if dt == "int8")
    assert tu / 1e9 == pytest.approx(3 * 219.0, abs=0.5)
    assert tg / 1e9 == pytest.approx(18 * 19.33, abs=0.1)
    # all-bf16 at batch 16: 6.93 ms at 989 TFLOP/s
    assert p2phd_global_512.infer_least_s(g, 16, False) * 1e3 == \
        pytest.approx(16 * 428.49e9 / 989e12 * 1e3, rel=1e-6)


def test_discriminator_and_train_flops():
    u = cfg("p2phd_r2l_msrb7_512")
    d = pix2pixhd_d.forward_flops(u, 1, 512)
    # scale at 512²: 257, 129, 65 after the stride-2 layers, 66, 67 after
    # the stride-1 ones; the second scale on the 256² pooled input
    first = (peaks.conv_flops(1, 257, 257, 2, 64, 4)
             + peaks.conv_flops(1, 129, 129, 64, 128, 4)
             + peaks.conv_flops(1, 65, 65, 128, 256, 4)
             + peaks.conv_flops(1, 66, 66, 256, 512, 4)
             + peaks.conv_flops(1, 67, 67, 512, 1, 4))
    assert d > first and d == pytest.approx(first * 1.25, rel=0.02)
    t = p2phd_r2l_msrb7_512.train_flops(u, 1)
    assert t / 1e12 == pytest.approx(2.98, abs=0.01)


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(1979e12, 0, "int8") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "bf16") == pytest.approx(1.0)
