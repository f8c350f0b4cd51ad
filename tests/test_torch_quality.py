"""Slice 19 of the port: the training-quality tools
(``cistar_tpu_torch/tools/{eval_r2l_fidelity,bf16_train_overlay,
quality_run_uda}.py``) against the JAX package's (``tools/*.py``) on the
CPU.

Tolerances: the fidelity rows fp32, within 1e-5 (the two generators sum
their convs in other orders: ~1e-7 of the outputs, and corr / L1 / PSNR
are means of them); the identity row (data alone) exactly; the overlay's
``summarize`` exactly (the same Python arithmetic); its data stream bit
for bit. The UDA driver's CSV headers and ``summary.json`` keys equal
those of ``docs/quality_run_uda/``. JAX's trainer is never compiled: the
JAX eval tool gets a state built by ``jax.eval_shape``, so only its
``infer_step`` compiles.
"""

import csv
import importlib.util
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from cistar_tpu.engines.p2phd import Pix2PixHD as JaxP2P
from cistar_tpu_torch.apps.p2phd_train import save_networks
from cistar_tpu_torch.data.datasets import Radar2LidarDataset
from cistar_tpu_torch.engines.p2phd import Pix2PixHD
from cistar_tpu_torch.tools import bf16_train_overlay as overlay
from cistar_tpu_torch.tools import eval_r2l_fidelity as fidelity
from cistar_tpu_torch.tools import quality_run_uda as uda
from cistar_tpu_torch.utils.fidelity import BUDGET


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
OPT_TXT = os.path.join(ROOT, "checkpoints", "r2l_MSRB_7", "opt.txt")
SIZE = 64
ROW_ABS = 1e-5
# the tiny UNet of the eval checks, on r2l_MSRB_7's other options
TINY = dict(ngf=8, n_blocks_global=1)
# checkpoint label → the seed of its weights; 10 after 2 checks the
# numeric order
EPOCH_SEEDS = {2: 1, 10: 2, "latest": 3}


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def r2l_data(tmp_path_factory):
    """6 scenes of ``make_synthetic_r2l`` at 64² (2 test frames), and 4
    for the UDA driver (1 train pair)."""
    root = tmp_path_factory.mktemp("quality")
    synth = _tool("make_synthetic_r2l")
    for name, n in (("r2l", 6), ("uda", 4)):
        synth.main(["--out", str(root / name), "--n", str(n), "--size",
                    str(SIZE)])
    return root


@pytest.fixture(scope="module")
def experiment(r2l_data):
    """Three checkpoints of the tiny UNet written by the port's
    ``save_networks`` from seeded weights."""
    ck = r2l_data / "ck"
    run = ck / "q"
    os.makedirs(run)
    eng = Pix2PixHD("UNet", image_size=SIZE, compute_dtype=torch.float32,
                    device="cpu", **TINY)
    for label, seed in EPOCH_SEEDS.items():
        eng.init_state(seed)
        save_networks(str(run), eng, label)
    return ck


def _eval_args(data, ck, data_type, *extra):
    return ["--load_opt", OPT_TXT, "--name", "q", "--checkpoints_dir",
            str(ck), "--dataroot", str(data / "r2l"), "--r2l_res", str(SIZE),
            "--ngf", str(TINY["ngf"]), "--n_blocks_global",
            str(TINY["n_blocks_global"]), "--data_type", str(data_type),
            "--device", "cpu", *extra]


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _state_of_shapes(monkeypatch):
    """JAX's ``Pix2PixHD.init_state`` → zeros of its shapes, traced by
    ``jax.eval_shape`` and never compiled (the tool loads G over them)."""
    init = JaxP2P.init_state

    def shapes(self, rng, image_size=None):
        st = jax.eval_shape(lambda k: init(self, k, image_size), rng)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), st)

    monkeypatch.setattr(JaxP2P, "init_state", shapes)


# --------------------------------------------------------------------------- #
# eval_r2l_fidelity
# --------------------------------------------------------------------------- #
def test_eval_rows_match_jax(r2l_data, experiment, monkeypatch):
    # the same epochs in the same order, corr / l1 / psnr within 1e-5, on
    # the same .npz files
    _state_of_shapes(monkeypatch)
    _tool("eval_r2l_fidelity").main(_eval_args(r2l_data, experiment, 32))
    path = experiment / "q" / "fidelity.csv"
    want = _read_csv(path)
    os.remove(path)
    out = fidelity.main(_eval_args(r2l_data, experiment, 32))
    got = _read_csv(path)
    assert [r["epoch"] for r in want] == ["2", "10", "latest"]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    assert list(got[0]) == fidelity.FIELDS == list(want[0])
    for g, w in zip(got, want):
        for k in ("corr", "l1", "psnr"):
            assert abs(float(g[k]) - float(w[k])) <= ROW_ABS, (g, w, k)
    # each row is its frames' means; the frames differ by epoch
    frames = out["frames"]
    assert [len(frames[ep]) for ep in EPOCH_SEEDS] == [2, 2, 2]
    for row in out["rows"]:
        assert row == fidelity.fidelity_row(row["epoch"],
                                            frames[row["epoch"]])
    assert out["rows"][1]["corr"] != out["rows"][2]["corr"]


def test_eval_identity_row_is_the_data_alone(r2l_data, experiment):
    # the radar itself as the fake, on the test split: exact, whatever the
    # generator, and the same from the port's dataset as from JAX's
    from cistar_tpu.data.datasets import Radar2LidarDataset as JaxR2L

    out = fidelity.main(_eval_args(r2l_data, experiment, 16,
                                   "--identity_row"))
    row = out["rows"][0]
    assert row["epoch"] == "identity" and len(out["rows"]) == 4
    for ds in (Radar2LidarDataset(str(r2l_data / "r2l"), size=SIZE,
                                  mode="test"),
               JaxR2L(str(r2l_data / "r2l"), size=SIZE, mode="test")):
        want = fidelity.fidelity_row("identity", [
            fidelity.frame_metrics(ds[i]["label"], ds[i]["image"])
            for i in range(len(ds))])
        assert row == want
    bf16_rows = _read_csv(experiment / "q" / "fidelity.csv")
    assert [r["epoch"] for r in bf16_rows] == ["identity", "2", "10",
                                                "latest"]


def test_eval_int8_engine_holds_to_fp32(r2l_data, experiment):
    # --data_type 8: the int8 engine (its plain versions on the CPU, no
    # launch), its own CSV, every epoch within the LPIPS budget of G's
    # fp32 forward and within 0.1 in corr of the fp32 row
    fp32 = {r["epoch"]: r for r in
            fidelity.main(_eval_args(r2l_data, experiment, 32))["rows"]}
    out = fidelity.main(_eval_args(r2l_data, experiment, 8))
    assert os.path.exists(experiment / "q" / "fidelity_int8.csv")
    assert set(out["int8"]) == set(EPOCH_SEEDS)
    for row in out["rows"]:
        hold = out["int8"][row["epoch"]]
        assert all(math.isfinite(row[k]) for k in ("corr", "l1", "psnr"))
        assert abs(row["corr"] - fp32[row["epoch"]]["corr"]) < 0.1
        assert 0 <= hold["lpips_metric"] < BUDGET
        assert 0 < hold["pixel_l1"] < 0.1
        assert hold["launches_per_frame"] == 0


# --------------------------------------------------------------------------- #
# bf16_train_overlay
# --------------------------------------------------------------------------- #
def test_overlay_summarize_is_jax():
    jo = _tool("bf16_train_overlay")
    rng = np.random.RandomState(0)
    curves = [{k: list(rng.rand(7) * 3) for k in ("loss_D", "loss_G",
                                                  "G_VGG")}
              for _ in range(3)]
    curves[2]["G_VGG"] = list(curves[0]["G_VGG"])   # no noise: ratio None
    curves[1]["loss_G"] = curves[1]["loss_G"][:5]   # a short curve
    assert overlay.summarize(*curves) == jo.summarize(*curves)
    assert overlay.summarize(*curves)["G_VGG"]["ratio"] is None


def test_overlay_data_stream_is_jax(monkeypatch):
    # the JAX tool's batches, recorded by a stand-in engine, bit for bit
    import cistar_tpu.engines.p2phd as jp
    import jax.numpy as jnp

    seen = []

    class Recorder:
        def __init__(self, **kw):
            seen.append(kw["image_size"])

        def init_state(self, rng, image_size=None):
            return None

        def train_step(self, state, label, inst, image):
            seen.append((np.asarray(label), np.asarray(image)))
            return state, {"loss": jnp.zeros(())}, None

    monkeypatch.setattr(jp, "Pix2PixHD", Recorder)
    _tool("bf16_train_overlay").run_curve("unet512", "fp32", 3, data_seed=5)
    assert seen[0] == overlay.CONFIGS["unet512"][0]
    stream = overlay.data_stream(seen[0], seed=5)
    for label, image in seen[1:]:
        mine = next(stream)
        for a, b in zip(mine, (label, image)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_overlay_runs_under_jax_metric_names(tmp_path, monkeypatch):
    # a tiny UNet patched into the table: 2 steps of each curve, finite,
    # under the names JAX's train step returns (traced, not compiled)
    cfg = (32, "UNet", 1, 4, {"n_blocks_global": 1})
    monkeypatch.setitem(overlay.CONFIGS, "tiny", cfg)
    size, net_g, num_d, ngf, kw = cfg
    jeng = JaxP2P(net_g=net_g, ngf=ngf, num_d=num_d, image_size=size, **kw)
    st = jax.eval_shape(jeng.init_state, jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((1, size, size, 1), np.float32)
    names = set(jax.eval_shape(
        lambda s, a, b: jeng.train_step(s, a, None, b), st, x, x)[1])
    out = tmp_path / "overlay.json"
    art = overlay.main(["--config", "tiny", "--steps", "2", "--out",
                        str(out), "--device", "cpu"])
    assert json.loads(out.read_text())["tiny"] == json.loads(
        json.dumps(art))
    for run in ("fp32", "bf16", "fp32_perturbed"):
        curves = art["curves"][run]
        assert set(curves) == names
        assert all(len(v) == 2 and all(map(math.isfinite, v))
                   for v in curves.values())
    assert set(art["summary"]) == names
    # the perturbation moved the run; the unperturbed start is seed 0's
    assert art["curves"]["fp32"]["loss_G"][0] != \
        art["curves"]["fp32_perturbed"]["loss_G"][0]


# --------------------------------------------------------------------------- #
# quality_run_uda
# --------------------------------------------------------------------------- #
def _header(path):
    with open(path) as f:
        return f.readline().strip().split(",")


def test_uda_driver_writes_jax_layout(r2l_data, tmp_path):
    # 4 pairs (1 to train on), 1 epoch, 1 pre-epoch: the CSVs' headers and
    # summary.json's keys of docs/quality_run_uda/, the strips written
    out = tmp_path / "uda"
    summary = uda.main(["--dataroot", str(r2l_data / "uda"), "--size",
                        str(SIZE), "--epochs", "1", "--pre_epochs", "1",
                        "--out", str(out), "--device", "cpu"])
    docs = os.path.join(ROOT, "docs", "quality_run_uda")
    for rel in ("ae/loss_log.csv", "critic/w_distance.csv",
                "transfer/loss_log.csv", "transfer/pretrain_radar.csv",
                "transfer/pretrain_lidar.csv"):
        assert _header(out / rel) == _header(os.path.join(docs, rel)), rel
    for rel in ("ae/cross_decode.png", "transfer/cross_decode.png"):
        assert os.path.getsize(out / rel) > 0
    with open(os.path.join(docs, "summary.json")) as f:
        want = json.load(f)
    got = json.loads((out / "summary.json").read_text())
    assert got == json.loads(json.dumps(summary))
    assert set(got) == set(want)
    for phase in ("ae", "critic", "transfer"):
        # JAX's tool times every phase (wall_s); the committed critic entry
        # predates that
        assert set(got[phase]) - set(want[phase]) <= {"wall_s"}
        assert set(want[phase]) <= set(got[phase])
        for k, v in want[phase].items():
            if isinstance(v, dict):
                assert set(got[phase][k]) == set(v), (phase, k)
                assert all(map(math.isfinite, got[phase][k].values()))


@pytest.mark.parametrize("run", [
    lambda d, t: fidelity.main([a for a in _eval_args(d, t / "ck", 16)
                                if a not in ("--device", "cpu")]),
    lambda d, t: overlay.main(["--config", "unet512", "--steps", "1",
                               "--out", str(t / "o.json")]),
    lambda d, t: uda.main(["--dataroot", str(d / "uda"), "--out",
                           str(t / "uda")])], ids=["eval", "overlay", "uda"])
def test_tools_need_cuda_without_a_device(r2l_data, experiment, tmp_path,
                                          monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(r2l_data, experiment.parent)
