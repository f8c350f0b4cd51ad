"""The attribution of `spans_trace.py` on synthetic timelines: idle split
by the innermost span open over each part, device time by the span open at
its launch, the sums that must hold; the window and gaps as
`trace.summarize` finds them; the accepted per-layer metrics reading a
record the same way with and without spans in it; and one small traced
run of an infer and the train cell on the CPU with the recorder on."""

import copy
import json
import random
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from _portbench_small import ROOT, small
from portbench import harness, spans_trace as st
from portbench import trace as tr

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def S(i, parent, name, t0, t1, root=0):
    return st.S(i, parent, root, name, t0, t1)


# root 0 [0, 100) holds a [10, 30) and b [40, 90), which holds c [50, 60);
# root 4 [120, 150)
SPANS = [S(0, None, "root", 0, 100), S(1, 0, "a", 10, 30),
         S(2, 0, "b", 40, 90), S(3, 2, "c", 50, 60),
         S(4, None, "root", 120, 150, root=4)]


def test_segments_name_the_innermost_span():
    assert st.segments(SPANS) == [
        (0, 10, 0), (10, 30, 1), (30, 40, 0), (40, 50, 2), (50, 60, 3),
        (60, 90, 2), (90, 100, 0), (100, 120, None), (120, 150, 4)]


def test_idle_is_split_across_span_boundaries():
    gaps = [(20, 55), (95, 125), (160, 170)]
    att = st.attribute((0, 200), gaps, SPANS, [], {})
    assert att["idle"] == pytest.approx(
        {1: 10, 0: 10 + 5, 2: 10, 3: 5, 4: 5, st.OUTSIDE: 20 + 10})


def test_device_time_goes_to_the_span_open_at_its_launch():
    device = [(52, 70, 7, "k"), (55, 58, 8, "k"), (95, 130, 9, "k"),
              (101, 105, 10, "k"), (190, 230, 11, "copy"), (10, 12, 12, "k")]
    launches = {7: 51.0, 8: 5.0, 9: 89.0, 10: 100.5, 11: 140.0}
    att = st.attribute((0, 200), [], SPANS, device, launches)
    # the innermost wins: 7 launched in c, inside b, inside the root
    assert att["device"] == pytest.approx(
        {3: 18, 0: 3, 2: 35, st.OUTSIDE: 4, 4: 10, st.UNLINKED: 2})
    assert att["launched"] == {3: 1, 0: 1, 2: 1, st.OUTSIDE: 1, 4: 1,
                               st.UNLINKED: 1}
    assert att["by_name"] == pytest.approx(
        {(3, "k"): 18, (0, "k"): 3, (2, "k"): 35, (st.OUTSIDE, "k"): 4,
         (4, "copy"): 10, (st.UNLINKED, "k"): 2})


def _random_timeline(rng):
    spans, t, i = [], 0.0, 0
    for _ in range(rng.randint(1, 6)):                     # roots
        t += rng.uniform(0, 5)
        r0, r1 = t, t + rng.uniform(20, 40)
        root = i
        spans.append(S(i, None, "root", r0, r1, root))
        i += 1
        u = r0
        for _ in range(rng.randint(0, 4)):                 # children
            a = u + rng.uniform(0, 3)
            b = min(r1, a + rng.uniform(0, 8))
            if b <= a:
                break
            spans.append(S(i, root, f"c{i % 3}", a, b, root))
            i += 1
            u = b
        t = r1
    busy = tr._union([(s, s + rng.uniform(0, 4))
                      for s in (rng.uniform(-5, t + 5) for _ in range(40))])
    return spans, (0.0, t + 3), busy


@pytest.mark.parametrize("seed", range(6))
def test_sums_hold_on_random_timelines(seed):
    rng = random.Random(seed)
    spans, win, busy = _random_timeline(rng)
    gaps = st.gaps_of(win, [(max(a, win[0]), min(b, win[1])) for a, b in busy
                            if min(b, win[1]) > max(a, win[0])])
    device = [(a, b, k, "k") for k, (a, b) in enumerate(busy)]
    launches = {k: rng.uniform(win[0], win[1]) for k in range(len(busy))
                if k % 5}
    att = st.attribute(win, gaps, spans, device, launches)
    # Σ idle by span + outside = the window's idle
    assert sum(att["idle"].values()) == pytest.approx(
        sum(b - a for a, b in gaps))
    # Σ device time by span + outside + unlinked = the device time
    assert sum(att["device"].values()) == pytest.approx(sum(
        max(0.0, min(b, win[1]) - max(a, win[0])) for a, b, _, _ in device))
    for k, v in att["idle"].items():
        assert v >= -1e-9, k


def _ev(name, start, end, dev=DeviceType.CUDA, kernels=()):
    return SimpleNamespace(name=name, device_type=dev, kernels=list(kernels),
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("host", [True, False], ids=["host", "card_only"])
def test_window_and_gaps_as_summarize_finds_them(host):
    k = [_ev("k1", 100, 300), _ev("k2", 250, 400), _ev("k3", 700, 900),
         _ev("k4", 1200, 5000), _ev("k5", 50, 80)]
    if host:
        evs = [_ev(tr.WINDOW, 90, 2000, DeviceType.CPU),
               _ev("aten::add", 95, 99, DeviceType.CPU)] + k
    else:
        evs = [_ev(tr.WINDOW, 90, 91)] + k          # the device annotation
    window_s = 1910e-6
    win, gaps = st.window_and_gaps(evs, window_s)
    summ = tr.summarize(evs, window_s)
    assert win == (90, 2000)
    assert gaps == [(90, 100), (400, 700), (900, 1200)]
    assert sum(b - a for a, b in gaps) * 1e-6 == pytest.approx(
        summ["window_s"] - summ["busy_s"])


def test_readings_and_table():
    spans = [S(0, None, "p2phd.infer", 0, 100),
             S(1, 0, "p2phd.stage_in", 0, 20), S(2, 0, "g.encode", 20, 40),
             S(3, 0, "g.trunk", 40, 80), S(4, 0, "g.decode", 80, 100),
             S(5, None, "p2phd.infer", 110, 200, root=5),
             S(6, 5, "p2phd.stage_in", 110, 130, root=5)]
    gaps = [(5, 15), (100, 115), (125, 140)]
    device = [(30, 50, 1, "conv"), (45, 90, 2, "cat"), (85, 99, 3, "cat")]
    launches = {1: 21.0, 2: 41.0, 3: 81.0}
    att = st.attribute((0, 200), gaps, spans, device, launches)
    got = st.readings(spans, att, (0, 200))
    # stage_in: 10 of (5, 15), 5 of (100, 115), 5 of (125, 140)
    assert got == pytest.approx({"stage_in_idle.infer": 100 * 20 / 200,
                                 "encode_ms.infer": 20e-3 / 2,
                                 "trunk_ms.infer": 45e-3 / 2,
                                 "decode_ms.infer": 14e-3 / 2})
    rows = st.table(spans, att, (0, 200))
    assert rows["p2phd.stage_in"]["idle_ms"] == pytest.approx(20e-3 / 2)
    # outside: (100, 110) alone; (130, 140) lies in the second call
    assert rows[st.OUTSIDE]["idle_ms"] == pytest.approx(10e-3 / 2)
    assert rows["p2phd.infer"]["idle_ms"] == pytest.approx(10e-3 / 2)
    assert rows["p2phd.infer"]["host_ms"] == pytest.approx(190e-3 / 2)
    [(what, ms)] = rows["g.trunk"]["top"]
    assert what == "cat" and ms == pytest.approx(45e-3 / 2)
    train = [S(0, None, "p2phd.train_step", 0, 100),
             S(1, 0, "g_forward", 0, 30), S(2, 1, "g.trunk", 10, 20),
             S(3, 0, "g_backward", 30, 60), S(4, 0, "g_adam", 60, 70),
             S(5, 0, "d_forward_backward", 70, 90), S(6, 0, "d_adam", 90, 100)]
    att = st.attribute((0, 100), [(5, 15), (35, 40), (65, 75), (95, 100)],
                       train, [], {})
    assert st.readings(train, att, (0, 100)) == pytest.approx(
        {"g_idle_ms.train": 15e-3, "d_idle_ms.train": 5e-3})


def test_clock_check_counts_what_lies_outside():
    spans = SPANS[:4] + [S(5, None, "p2phd.infer", 200, 300, root=5),
                         S(6, 5, "g.trunk", 220, 260, root=5),
                         S(7, 5, "g.encode", 205, 219, root=5)]
    launches = [("cudaLaunchKernel", 210, 211), ("cudaLaunchKernel", 290, 310),
                ("cuLaunchKernelEx", 340, 341), ("cudaLaunchKernel", 5, 6)]
    ops = [("cistar::msrb_branch_int8", 221, 259),
           ("cistar::msrb_branch_int8", 210, 230),
           ("cistar::other", 206, 215)]
    got = st.clock_check(spans, (100, 1000), launches, ops)
    assert got["launches"] == {"n": 3, "outside": 1, "worst_us": 41.0}
    assert got["trunk_ops"] == {"n": 2, "outside": 0, "worst_us": 10.0}
    assert got["other_ops"] == {"n": 1, "outside": 0, "worst_us": 0.0}


def _record(name):
    """A traced run's record of the cell as the metrics read it, with
    numbers in place of a card's."""
    cell, cfg = harness.cell_files(name)
    summary = {"busy_s": 4.8, "window_s": 5.0, "device_ops": [],
               "idle_gaps": [],
               "op_calls": {"msrb_branch_int8": 120,
                            "resblock_int8_tiled_a": 90,
                            "resblock_int8_tiled_b": 90},
               "op_device_s": {"msrb_branch_int8": 0.6,
                               "resblock_int8_tiled_a": 0.3,
                               "resblock_int8_tiled_b": 0.35}}
    return dict(trace=summary, calls=100, steps=120,
                batch=cell["params"]["batch"], window_s=51.0,
                adam_ms=[7.3, 7.4], cell=cell, cfg=cfg,
                counts=harness.counts(cfg))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_accepted_metrics_read_the_same_with_spans(w):
    rec = _record(w["name"])
    with_spans = copy.deepcopy({k: v for k, v in rec.items()
                                if k != "counts"})
    with_spans["counts"] = rec["counts"]
    with_spans["trace"]["spans"] = {"readings": {"trunk_ms.infer": 1.0},
                                    "table": {}, "counters": {}}
    for m in harness.reported(BENCH, "per_layer", w["name"]):
        mod = harness.metric_module(m["name"])
        assert mod.read(with_spans) == mod.read(rec), m["name"]


@pytest.mark.parametrize("name,root", [
    ("msrb7_512.int8_b8", "p2phd.infer"),
    ("msrb7_512.train_b1", "p2phd.train_step")])
def test_a_small_traced_run_records_spans(name, root, monkeypatch):
    import time
    import torch
    cell, cfg = small(name)
    traffic = harness.traffic(cell)
    monkeypatch.setattr(traffic, "Trace", st.SpanTrace)
    result, out = harness.run_cell(name, 7, 0.3, True, torch.device("cpu"),
                                   time.perf_counter(), cell, cfg)
    assert result["correct"] is True
    assert set(result) - {"breakdown"} == {"correct", "attempted", "failed",
                                           "metrics", "device", "checks"}
    sp = out.record["trace"]["spans"]
    assert st.SpanTrace.last is sp
    assert sp["calls"] >= 1 and sp["dropped"] == 0
    assert sp["per_s"] == pytest.approx(
        sp["calls"] / out.record["trace"]["window_s"])
    assert root in sp["table"] and st.OUTSIDE in sp["table"]
    assert {"g.encode", "g.trunk", "g.decode"} <= set(sp["table"])
    # no card: the whole window is idle, and every part has an owner
    assert sp["idle_pct"] == pytest.approx(100.0)
    assert sp["device_idle_pct"] == pytest.approx(100.0)
    want = ({"stage_in_idle.infer", "encode_ms.infer", "trunk_ms.infer",
             "decode_ms.infer"} if root == "p2phd.infer"
            else {"g_idle_ms.train", "d_idle_ms.train"})
    assert set(sp["readings"]) == want
    lines = st.format_table(sp)
    assert lines[1].split() == ["span", "host_ms", "idle_ms", "launched",
                                "device_ms"]
