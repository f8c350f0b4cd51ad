"""Each cell's comparison fails its control (the reference at the
precision below the configuration's, in the program's place) and fails a
run whose timed path is broken underneath: an answer altered where it is
produced, half the batch left out, a train step that leaves its state
unchanged."""

import pytest

from _portbench_small import ctx, run, small
from portbench import harness

INFER = ["msrb7_512.int8_b8", "global_512.int8_b16", "global_512.bf16_b16"]
# the smallest sizes at published widths where the controls already fail
# (the cells' 512² reads wider: PERF.md)
CONTROL = {"msrb7_512.int8_b8": dict(fineSize=256),
           "global_512.int8_b16": dict(fineSize=64, n_blocks_global=3),
           "global_512.bf16_b16": dict(fineSize=64, n_blocks_global=3),
           "msrb7_512.train_b1": dict(fineSize=64, ngf=8, ndf=8,
                                      n_blocks_global=1)}


@pytest.mark.parametrize("name", list(CONTROL))
def test_control_fails_the_limits(name):
    fcell, fcfg = harness.cell_files(name)
    cell, _ = small(name)
    cfg = dict(fcfg, **CONTROL[name])
    cell["params"].update(batch=1, ring_frames=1, ring_pairs=4)
    got = harness.traffic(cell).control(ctx(name, 2, cell, cfg))
    limits = {k: v["limit"] for k, v in fcell["checks"].items()}
    assert any(got[k] > lim for k, lim in limits.items()), (got, limits)


@pytest.mark.parametrize("name", INFER + ["msrb7_512.train_b1"])
def test_a_sound_run_is_correct(name):
    result, _ = run(name)
    assert result["correct"] is True, result["checks"]


def _entry(name):
    return ("infer_step_int8" if "int8" in name else "infer_step")


def _alter_one(y):
    y = y.clone()
    y[0] = -y[0]
    return y


def _drop_half(y):
    y = y.clone()
    y[y.shape[0] // 2:] = y[:y.shape[0] // 2]
    return y


@pytest.mark.parametrize("fault", [_alter_one, _drop_half],
                         ids=["answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("name", INFER)
def test_a_broken_infer_path_is_not_correct(name, fault, monkeypatch):
    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    real = getattr(Pix2PixHDInference, _entry(name))
    monkeypatch.setattr(Pix2PixHDInference, _entry(name),
                        lambda self, *a, **k: fault(real(self, *a, **k)))
    result, _ = run(name)
    assert result["correct"] is False


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    import cistar_tpu_torch.engines.p2phd as engine
    monkeypatch.setattr(engine, "adam_step", lambda *a, **k: None)
    result, _ = run("msrb7_512.train_b1")
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_train_step_with_an_altered_fake_is_not_correct(monkeypatch):
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    real = Pix2PixHD._g
    monkeypatch.setattr(Pix2PixHD, "_g",
                        lambda self, x: real(self, x) * 0.9)
    result, _ = run("msrb7_512.train_b1")
    assert result["correct"] is False
