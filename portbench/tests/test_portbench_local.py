"""The cell of pix2pixHD's `local` generator and that of the loader-fed
recipe (`msrb7_512.train_loader`, built but not listed in BENCHMARK.json)
at small sizes on the CPU: sound runs are correct, broken ones are
not (the local output altered, its fine stream skipped; a train step fed
an altered batch), ``enhance_ms.infer`` reads the device time of the
``g.enhance`` subtree off a synthetic timeline, and the configuration's
counts give 568.7 GFLOP a frame at the published widths."""

import json

import pytest
import torch

from _portbench_small import ROOT, run
from portbench import harness, spans_trace as st
from portbench.counts import p2phd_global_512, p2phd_local_1024
from portbench.traffic import infer_local

LOCAL, LOADER = "local_1024.int8_b4", "msrb7_512.train_loader"


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", [LOCAL, LOADER])
def test_a_sound_run_is_correct(name, trace):
    result, out = run(name, trace=trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    if trace and name == LOCAL:
        # no card: the subtree launched nothing, and the reading says so
        assert result["metrics"]["enhance_ms.infer"]["value"] == 0.0
        assert {"g.encode", "g.trunk", "g.decode", "g.enhance"} <= set(
            out.record["trace"]["spans"]["table"])


def _alter_one(self, *a, real, **k):
    y = real(self, *a, **k).clone()
    y[0] = -y[0]
    return y


def test_an_altered_local_output_is_not_correct(monkeypatch):
    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    real = Pix2PixHDInference.infer_step_int8
    monkeypatch.setattr(Pix2PixHDInference, "infer_step_int8",
                        lambda self, *a, **k: _alter_one(self, *a, real=real,
                                                         **k))
    result, _ = run(LOCAL)
    assert result["correct"] is False


def test_a_skipped_fine_stream_is_not_correct(monkeypatch):
    import torch.nn.functional as F
    from cistar_tpu_torch.models import fast_infer as fi

    def global_upsampled(gen, h, pyr):
        for m in gen.global_trunk.up:
            h = m(h)
        m = h.mean(-1, keepdim=True).permute(0, 3, 1, 2)
        return torch.tanh(F.interpolate(m, scale_factor=2)).permute(0, 2, 3,
                                                                    1)
    monkeypatch.setattr(fi, "local_decode", global_upsampled)
    result, _ = run(LOCAL)
    assert result["correct"] is False


def test_a_step_fed_an_altered_batch_is_not_correct(monkeypatch):
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    real = Pix2PixHD.train_step
    monkeypatch.setattr(
        Pix2PixHD, "train_step",
        lambda self, state, label, inst, image, **k: real(
            self, state, -label, inst, image, **k))
    result, _ = run(LOADER)
    assert result["correct"] is False


def S(i, parent, name, t0, t1, root=0):
    return st.S(i, parent, root, name, t0, t1)


def test_enhance_reading_of_a_synthetic_timeline():
    # two calls; the second's g.enhance holds a span of its own
    spans = [S(0, None, "p2phd.infer", 0, 100),
             S(1, 0, "g.trunk", 10, 40), S(2, 0, "g.enhance", 50, 100),
             S(3, None, "p2phd.infer", 110, 200, root=3),
             S(4, 3, "g.enhance", 150, 200, root=3),
             S(5, 4, "inner", 160, 170, root=3)]
    device = [(20, 60, 1, "k7"), (60, 90, 2, "cat"), (155, 180, 3, "conv"),
              (175, 190, 4, "cat"), (195, 210, 5, "head")]
    launches = {1: 15.0, 2: 55.0, 3: 151.0, 4: 165.0, 5: 199.0}
    att = st.attribute((0, 220), [], spans, device, launches)
    got = infer_local.reading(spans, att, (0, 220))
    assert got == pytest.approx((30 + 25 + 15 + 15) / 1e3 / 2)
    assert infer_local.reading(spans[:2], att, (0, 220)) is None
    mod = harness.metric_module("enhance_ms.infer")
    rec = {"trace": {"spans": {"readings": {"enhance_ms.infer": got}}}}
    assert mod.read(rec) == got
    assert mod.read({"trace": {"spans": {"readings": {}}}}) is None
    assert mod.read({"trace": {"busy_s": 1.0}}) is None
    assert mod.read({"trace": None}) is None


def test_local_counts_at_the_published_widths():
    cfg = _cfg("p2phd_local_1024")
    convs = p2phd_local_1024.generator_convs(cfg, 1, True)
    assert sum(f for f, _ in convs) / 1e9 == pytest.approx(568.7, abs=0.05)
    assert sum(f for f, dt in convs if dt == "int8") / 1e9 == \
        pytest.approx(347.9, abs=0.05)
    # the global G without its head is global_512's
    g = _cfg("p2phd_global_512")
    head = p2phd_global_512.generator_convs(g, 1, True)[-1][0]
    glob = sum(f for f, _ in p2phd_global_512.generator_convs(g, 1, True))
    # the enhancer: stem, down, 6 resnet convs, up; then the head
    assert sum(f for f, _ in convs[:len(convs) - 10]) == \
        pytest.approx(glob - head)
    assert p2phd_local_1024.infer_least_s(cfg, 4, True) * 1e3 == \
        pytest.approx(1.596, abs=5e-4)
    assert p2phd_local_1024.kernel_bounds(cfg, 4) == \
        p2phd_global_512.kernel_bounds(g, 4)
