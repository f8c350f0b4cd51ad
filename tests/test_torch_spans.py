"""The port's span and counter recorder (``runtime/spans.py``) and the spans
the pix2pixHD engines open: off by default and then inert, nesting and
request ids, the cap, the phase spans of the train step beside its
``mark`` callback, and the clock that lays spans over a ``torch.profiler``
trace."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cistar_tpu_torch.engines.p2phd import Pix2PixHD, Pix2PixHDInference
from cistar_tpu_torch.runtime import spans

INFER = ["p2phd.infer", "p2phd.stage_in", "g.encode", "g.trunk", "g.decode"]
PHASES = ["g_forward", "g_backward", "g_adam", "d_forward_backward",
          "d_adam"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_off_records_nothing():
    assert not spans.active()
    s = spans.span("a")
    assert s is spans.OFF and spans.span("b") is spans.OFF
    with s as entered:
        assert entered is spans.OFF
        spans.count("n", 3)
    assert spans.phases() is spans.phases()
    marks = []
    ph = spans.phases(marks.append)
    ph.end("one")
    ph.end("two", last=True)
    assert marks == ["one", "two"]
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {} and rec.dropped == 0


def test_nesting_ids_and_counters():
    with spans.recording() as rec:
        with spans.span("a"):
            spans.count("n")
            with spans.span("b"):
                with spans.span("c"):
                    spans.count("n", 4)
            with spans.span("d"):
                pass
        with spans.span("e"):
            spans.count("m", 2)
        assert rec.spans == []          # handed over when recording ends
    assert not spans.active()
    got = [(s.id, s.parent_id, s.root_id, s.name) for s in rec.spans]
    assert got == [(0, None, 0, "a"), (1, 0, 0, "b"), (2, 1, 0, "c"),
                   (3, 0, 0, "d"), (4, None, 4, "e")]
    assert rec.counters == {"n": 5, "m": 2} and rec.dropped == 0
    by = {s.name: s for s in rec.spans}
    for child, parent in (("b", "a"), ("c", "b"), ("d", "a")):
        assert by[parent].t0_ns <= by[child].t0_ns <= by[child].t1_ns \
            <= by[parent].t1_ns
    assert by["b"].t1_ns <= by["d"].t0_ns and by["a"].t1_ns <= by["e"].t0_ns


def test_cap_counts_dropped_spans():
    with spans.recording(cap=3) as rec:
        with spans.span("a"):
            with spans.span("b"):
                pass
            with spans.span("c"):
                with spans.span("c1"):     # past the cap, with its parent
                    pass
        with spans.span("d"):
            pass
    assert [s.name for s in rec.spans] == ["a", "b", "c"]
    assert rec.dropped == 2
    assert all(s.t1_ns >= s.t0_ns > 0 for s in rec.spans)


def test_recording_is_not_reentrant_and_ends_on_error():
    with pytest.raises(ValueError):
        with spans.recording() as rec:
            with spans.span("a"):
                with pytest.raises(RuntimeError, match="already"):
                    with spans.recording():
                        pass
                raise ValueError
    assert not spans.active()
    assert [s.name for s in rec.spans] == ["a"]


def test_a_phase_cut_short_by_an_error_ends_with_its_step():
    with spans.recording() as rec:
        with pytest.raises(ValueError):
            with spans.span("step"):
                ph = spans.phases()
                ph.end("p1")
                raise ValueError            # inside the second phase
        with spans.span("next"):
            pass
    got = [(s.name, s.parent_id, s.root_id) for s in rec.spans]
    assert got == [("step", None, 0), ("p1", 0, 0), ("phase", 0, 0),
                   ("next", None, 3)]
    step, cut, nxt = rec.spans[0], rec.spans[2], rec.spans[3]
    assert cut.t1_ns == step.t1_ns <= nxt.t0_ns


def test_phases_are_spans_and_marks():
    marks = []
    with spans.recording() as rec:
        with spans.span("step"):
            ph = spans.phases(marks.append)
            with spans.span("inner"):
                pass
            ph.end("p1")
            ph.end("p2", last=True)
    assert marks == ["p1", "p2"]
    got = [(s.name, s.parent_id) for s in rec.spans]
    assert got == [("step", None), ("p1", 0), ("inner", 1), ("p2", 0)]
    p1, p2 = rec.spans[1], rec.spans[3]
    assert p1.t1_ns <= p2.t0_ns


def _label(b, size=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, size, size, 1, generator=g) * 2 - 1


@pytest.mark.parametrize("net_g", ["UNet", "global"])
@pytest.mark.parametrize("entry", ["infer_step", "infer_step_int8"])
def test_infer_spans(net_g, entry):
    eng = Pix2PixHDInference(net_g, ngf=8, n_downsample_global=2,
                             n_blocks_global=1, compute_dtype=torch.float32,
                             device="cpu")
    x = _label(2)
    call = (eng.infer_step if entry == "infer_step" else
            lambda v: eng.infer_step_int8(eng.quantize_generator(), v))
    ref = call(x)
    with spans.recording() as rec:
        out = call(x)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert [s.name for s in rec.spans] == INFER
    root = rec.spans[0]
    assert root.parent_id is None
    assert all(s.parent_id == root.id and s.root_id == root.id
               for s in rec.spans[1:])
    for a, b in zip(rec.spans[1:], rec.spans[2:]):
        assert a.t1_ns <= b.t0_ns
    assert rec.counters == {}           # no copy to a device on the CPU


def test_pageable_bytes_count_unpinned_host_inputs():
    eng = Pix2PixHDInference("UNet", ngf=8, n_blocks_global=1,
                             compute_dtype=torch.float32, device="cpu")
    eng.device = torch.device("cuda")   # what an engine on a card copies to
    x = _label(2)
    with spans.recording() as rec:
        eng._count_pageable(x, None)
    assert rec.counters == {"stage_in.pageable_bytes": x.numel() * 4}


def test_train_step_spans_and_marks():
    eng = Pix2PixHD("UNet", ngf=8, ndf=8, num_d=2, n_layers_d=2,
                    n_blocks_global=1, image_size=32,
                    compute_dtype=torch.float32, device="cpu")
    state = eng.init_state(0)
    label, image = _label(1, seed=1), _label(1, seed=2)
    marks = []
    state, _, _ = eng.train_step(state, label, None, image,
                                 mark=marks.append)
    assert marks == PHASES
    marks.clear()
    with spans.recording() as rec:
        eng.train_step(state, label, None, image, mark=marks.append)
    assert marks == PHASES
    assert rec.counters == {}
    names = [s.name for s in rec.spans]
    assert names == ["p2phd.train_step", "g_forward", "g.encode", "g.trunk",
                     "g.decode"] + PHASES[1:]
    by = {s.name: s for s in rec.spans}
    assert all(by[p].parent_id == 0 for p in PHASES)
    assert all(by[g].parent_id == by["g_forward"].id
               for g in ("g.encode", "g.trunk", "g.decode"))
    assert all(s.root_id == 0 for s in rec.spans)
    for a, b in zip(PHASES, PHASES[1:]):
        assert by[a].t1_ns <= by[b].t0_ns

    def fail_after_g_forward(label):
        if label == "g_forward":
            raise ValueError
    with spans.recording() as rec:
        with pytest.raises(ValueError):
            eng.train_step(state, label, None, image,
                           mark=fail_after_g_forward)
        with spans.span("next"):
            pass
    assert [s.name for s in rec.spans][-2:] == ["phase", "next"]
    assert rec.spans[-1].parent_id is None
    assert rec.spans[-1].root_id == rec.spans[-1].id


def test_spans_share_the_profiler_clock():
    # record_function events opened inside spans fall inside them once
    # both are on time.time_ns()'s clock
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            for i in range(20):
                with spans.span(f"s{i}"):
                    with record_function(f"r{i}"):
                        torch.ones(64).sum()
                    time.sleep(0.0005 * (i % 3))
    start = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("r")}
    assert len(events) == 20
    slack_us = 50.0
    for s in rec.spans:
        e = events["r" + s.name[1:]]
        s0 = (rec.to_unix_ns(s.t0_ns) - start) / 1e3
        s1 = (rec.to_unix_ns(s.t1_ns) - start) / 1e3
        assert s0 - slack_us <= e.time_range.start, (s.name, s0, e)
        assert e.time_range.end <= s1 + slack_us, (s.name, s1, e)
