"""Slice 15 of the port, its host side: ``data/datasets.py::UDADataset``,
``apps/p2phd_train.py --uda`` (``train_uda``), ``engines/ui.py`` (the edits
and ``EditSession``) and ``apps/encode_features.py`` (the feature maps,
the cluster table and the port's own k-means), against the JAX package on
the CPU. The trainers themselves are held to JAX in
``tests/test_torch_extended.py``.

Tolerances: dataset items, the saved checkpoints and the UI edits exactly;
synthesized frames and feature maps fp32, within 1e-5 (the order of sums;
3e-7 measured); the k-means against scikit-learn's ``KMeans(n_init=10,
random_state=0)``: the same centres (to 1e-9) on well-separated blobs, and
an inertia within 1% on encoder features (0.0% measured).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cistar_tpu.apps import encode_features as jencode
from cistar_tpu.core import checkpoint as jckpt
from cistar_tpu.data import datasets as jdata
from cistar_tpu.engines import factory as jfactory
from cistar_tpu.engines import ui as jui
from cistar_tpu.engines.p2phd import Pix2PixHD as JaxP2P
from cistar_tpu_torch.apps import (encode_features, p2phd_options,
                                   p2phd_train)
from cistar_tpu_torch.core import checkpoint as ckpt
from cistar_tpu_torch.data import datasets as data
from cistar_tpu_torch.engines import extended as px
from cistar_tpu_torch.engines import ui
from cistar_tpu_torch.engines.p2phd import Pix2PixHD, Pix2PixHDInference
from cistar_tpu_torch.models import pix2pixhd as pm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE = 32
OUT_ABS = 1e-5


def _write_pairs(root, names, size, seed=0):
    rng = np.random.RandomState(seed)
    for d in ("radar", "lidar"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for name in names:
            arr = (rng.rand(size, size) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, d, f"{name}.png"))


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """10 pairs of 40² frames (which the datasets resize), one run with a
    ``timestamp.txt`` listing 7 of 12 stamps out of order, and 12 pairs of
    32² frames for the CLIs."""
    root = tmp_path_factory.mktemp("uda_data")
    _write_pairs(str(root / "plain"), [f"{i:05d}" for i in range(10)], 40)
    stamps = [f"{1_500_000 + 37 * i}" for i in range(12)]
    _write_pairs(str(root / "stamped"), stamps, 40, seed=1)
    order = [stamps[i] for i in (5, 0, 9, 3, 11, 7, 2)]
    (root / "stamped" / "timestamp.txt").write_text(
        "\n".join(order) + "\n\n")
    _write_pairs(str(root / "cli"), [f"{i:05d}" for i in range(12)], SIZE,
                 seed=2)
    return root


# --------------------------------------------------------------------------- #
# UDADataset
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sub", ["plain", "stamped"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_uda_dataset_matches_jax(dataroot, sub, mode):
    # the pairs (sorted, or timestamp.txt's order), the 30% split, PIL's
    # resize, the normalization: item for item, exactly
    root = str(dataroot / sub)
    ds = data.UDADataset(root, size=SIZE, mode=mode)
    jds = jdata.UDADataset(root, size=SIZE, mode=mode)
    n_all = 7 if sub == "stamped" else 10
    assert len(ds) == len(jds) == (int(n_all * 0.3) if mode == "train"
                                   else n_all - int(n_all * 0.3))
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert set(a) == set(b) and a["path"] == b["path"]
        for k in ("radar", "lidar"):
            assert a[k].dtype == b[k].dtype == np.float32
            assert a[k].shape == (SIZE, SIZE, 1)
            np.testing.assert_array_equal(a[k], b[k])
    if sub == "stamped" and mode == "train":
        assert [os.path.basename(p) for p in ds.radar] == [
            "1500185.png", "1500000.png"]


# --------------------------------------------------------------------------- #
# p2phd_train --uda
# --------------------------------------------------------------------------- #
OPT_TXT = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints",
                       "r2l_MSRB_7", "opt.txt")


def _uda_args(root, ck, *extra):
    return ["--load_opt", OPT_TXT, "--uda", "--dataroot", str(root / "cli"),
            "--r2l_res", str(SIZE), "--ngf", "4", "--ndf", "4",
            "--n_downsample_global", "1", "--max_ch", "8", "--niter", "1",
            "--niter_decay", "0", "--print_freq", "1", "--checkpoints_dir",
            str(ck), "--device", "cpu", *extra]


def _like(shapes):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("module,labels", [
    ("discriminator", ("img_D",)),
    ("autoencoder", ("E", "DF", "DR", "DL", "GL", "GR"))])
def test_uda_cli_trains_and_saves_jax_layout(dataroot, tmp_path, module,
                                             labels):
    # the default module (the image critic) and the autoencoder: one epoch
    # of the 30% split (3 of 12 pairs; --max_dataset_size cuts nothing
    # here, as in JAX), the latest nets as .npz files that load, strict,
    # into the JAX state's trees and equal the port's nets; no iter.txt, no
    # statistics
    ck = tmp_path / "ck"
    extra = ["--max_dataset_size", "1"] + (
        ["--training_module", module] if module != "discriminator" else [])
    st = p2phd_train.main(_uda_args(dataroot, ck, *extra))
    run = ck / "r2l_MSRB_7"
    files = sorted(f for f in os.listdir(run) if f.endswith(".npz"))
    assert files == sorted(f"latest_net_{lab}.npz" for lab in labels)
    assert not os.path.exists(run / "iter.txt")
    log = open(run / "loss_log.csv").read().splitlines()
    assert len(log) == 2
    opt = p2phd_options.TrainOptions().parse(
        _uda_args(dataroot, ck, *extra), save=False)
    jeng = jfactory.create_uda_model(opt)
    if module == "discriminator":
        assert int(st.opt.count) == 3
        shapes = jax.eval_shape(lambda k: jeng.init_state(k, SIZE),
                                jax.random.PRNGKey(0))
        fields = (("img_D", shapes.d, st.d),)
    else:
        assert all(int(o.count) == 3 for o in st.opts.values())
        shapes = jax.eval_shape(jeng.init_state, jax.random.PRNGKey(0))
        fields = tuple((label, getattr(shapes, f), getattr(st, f))
                       for label, f in p2phd_train.UDA_LABELS)
    for label, like, params in fields:
        got = _from_jax(jckpt.load_network(str(run), label, "latest",
                                           _like(like), strict=True))
        assert set(got) == set(params), label
        for k, v in params.items():
            assert torch.equal(got[k], v.detach()), (label, k)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _from_jax(tree):
    from cistar_tpu_torch.core.convert import generator_from_jax

    return generator_from_jax(_np(tree), batch_stats={})


def test_uda_cli_needs_cuda_without_a_device(dataroot, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _uda_args(dataroot, tmp_path) if a not in (
        "--device", "cpu")]
    for extra in ([], ["--training_module", "autoencoder"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            p2phd_train.main(args + extra)
    with pytest.raises(RuntimeError, match="CUDA"):
        px.R2LTransfer(ngf=4, n_downsampling=2, n_scale=2)


# --------------------------------------------------------------------------- #
# the UI
# --------------------------------------------------------------------------- #
def _maps(seed, size=SIZE):
    r = np.random.RandomState(seed)
    label = r.randint(0, 4, (size, size)).astype(np.int32)
    inst = label.copy()
    inst[8:20, 8:20] = 2001
    inst[24:30, 2:9] = 3000
    return label, inst


def test_ui_edits_match_jax():
    label, inst = _maps(0)
    cases = [
        (ui.change_label, jui.change_label, ((10, 10), 3)),   # id ≥ 1000
        (ui.change_label, jui.change_label, ((0, 0), 2)),
        (ui.add_strokes, jui.add_strokes,
         (np.array([0, 5, 31]), np.array([3, 5, 30]), 5, 7)),
        (ui.add_object, jui.add_object,
         (label[4:16, 4:16], inst[4:16, 4:16], (25, 27), 2001)),
    ]
    for fn, jfn, args in cases:
        got, want = fn(label, inst, *args), jfn(label, inst, *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    feat = np.random.RandomState(1).randn(SIZE, SIZE, 3).astype(np.float32)
    centers = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    got = ui.set_object_style(feat, inst, 2001, centers, 2)
    np.testing.assert_array_equal(
        got, jui.set_object_style(feat, inst, 2001, centers, 2))
    assert (got[inst == 2001] == centers[2]).all()
    assert np.array_equal(got[inst != 2001], feat[inst != 2001])


def test_edit_session_matches_jax():
    # the synthesis, an edit composited inside its box + 64-pixel margin,
    # and a style switch through the feature channels: the port's engine
    # against JAX's EditSession on the same weights
    kw = dict(net_g="global", ngf=4, n_downsample_global=2,
              n_blocks_global=1, label_nc=4, r2l=False, no_instance=False)
    label, inst = _maps(3, size=96)
    eng = Pix2PixHDInference(device="cpu", compute_dtype=torch.float32,
                             **kw)
    jeng = JaxP2P(compute_dtype=jnp.float32, **kw)
    g = eng.jax_params()["G"]
    s, js = ui.EditSession(eng, label, inst), jui.EditSession(jeng, g, label,
                                                              inst)
    np.testing.assert_allclose(s.current, js.current, rtol=0, atol=OUT_ABS)
    before = s.current.copy()
    args = (np.array([70, 75]), np.array([80, 85]), 3, 1)
    got = s.apply(ui.add_strokes, *args, region=(70, 80, 76, 86))
    want = js.apply(jui.add_strokes, *args, region=(70, 80, 76, 86))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ABS)
    # outside the dilated box the old frame stays
    assert np.array_equal(got[:6], before[:6])
    assert not np.array_equal(got[6:], before[6:])

    fkw = dict(kw, instance_feat=True, load_features=True, feat_num=3)
    feng = Pix2PixHD(device="cpu", compute_dtype=torch.float32, ndf=4,
                     **fkw)
    jfeng = JaxP2P(compute_dtype=jnp.float32, ndf=4, **fkw)
    feat = np.zeros((96, 96, 3), np.float32)
    centers = np.random.RandomState(4).randn(5, 3).astype(np.float32)
    gf = feng.jax_params()["G"]
    s = ui.EditSession(feng, label, inst, feat)
    js = jui.EditSession(jfeng, gf, label, inst, feat)
    got, want = s.set_style(2001, centers, 1), js.set_style(2001, centers, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ABS)
    assert (s.feat[inst == 2001] == centers[1]).all()
    with pytest.raises(ValueError, match="feature map"):
        ui.EditSession(eng, label, inst).set_style(2001, centers, 1)


# --------------------------------------------------------------------------- #
# encode_features and the k-means
# --------------------------------------------------------------------------- #
def _encoder_run(tmp_path):
    """A JAX-layout E checkpoint (the port's encoder from seed 5) both CLIs
    load."""
    torch.manual_seed(5)
    enc = pm.Encoder(1, 3, 4, 2)
    from cistar_tpu_torch.core.convert import generator_to_jax

    ck = tmp_path / "ck"
    ckpt.save_network(str(ck / "run"), "E", "latest",
                      generator_to_jax(enc.state_dict()))
    return ["--checkpoints_dir", str(ck), "--name", "run", "--nef", "4",
            "--n_downsample_E", "2", "--size", str(SIZE), "--label_nc", "0"]


def test_encode_features_maps_match_jax(dataroot, tmp_path):
    # the pooled feature map of each train frame (no rotation), from the
    # same saved encoder: file for file
    common = _encoder_run(tmp_path)
    roots = {}
    for name, fn in (("port", encode_features.main), ("jax", jencode.main)):
        root = tmp_path / name
        _write_pairs(str(root), [f"{i:05d}" for i in range(10)], 40, seed=6)
        extra = ["--device", "cpu"] if name == "port" else []
        fn(["--mode", "maps", "--dataroot", str(root), *common, *extra])
        roots[name] = root / "feat"
    names = sorted(os.listdir(roots["port"]))
    assert names == sorted(os.listdir(roots["jax"])) and len(names) == 7
    for n in names:
        a, b = np.load(roots["port"] / n), np.load(roots["jax"] / n)
        assert a.shape == b.shape == (SIZE, SIZE, 3) and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=OUT_ABS)


def test_encode_features_cluster_writes_centres(dataroot, tmp_path):
    # 7 train frames, 3 clusters of label 0, the format sample_features
    # reads; the same centres as the JAX CLI's (scikit-learn's)
    common = _encoder_run(tmp_path)
    root = tmp_path / "data"
    _write_pairs(str(root), [f"{i:05d}" for i in range(10)], 40, seed=7)
    args = ["--mode", "cluster", "--dataroot", str(root), "--n_clusters",
            "3", *common]
    got = encode_features.main(args + ["--device", "cpu"])
    saved = np.load(tmp_path / "ck" / "run" / "features_clustered_003.npy",
                    allow_pickle=True).item()
    assert set(got) == set(saved) == {0}
    assert saved[0].shape == (3, 3) and saved[0].dtype == np.float32
    jencode.main(args)
    want = np.load(tmp_path / "ck" / "run" / "features_clustered_003.npy",
                   allow_pickle=True).item()
    np.testing.assert_allclose(_rows(saved[0]), _rows(want[0]), rtol=0,
                               atol=1e-5)


def _rows(c):
    """The centres in lexicographic row order."""
    return c[np.lexsort(c.T[::-1])]


def test_kmeans_finds_separated_centres_as_sklearn():
    from sklearn.cluster import KMeans

    r = np.random.RandomState(0)
    true = r.randn(6, 3) * 20
    x = np.concatenate([c + r.randn(40, 3) for c in true])
    got, inertia = encode_features.kmeans(x, 6)
    km = KMeans(n_clusters=6, n_init=10, random_state=0).fit(x)
    np.testing.assert_allclose(_rows(got), _rows(km.cluster_centers_),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(inertia, km.inertia_, rtol=1e-9)


def test_kmeans_inertia_near_sklearn_on_encoder_features():
    # the unpooled encoder output of 4 frames, every pixel a row (4,096
    # rows, 3 features), 10 clusters: inertia within 1% of scikit-learn's
    from sklearn.cluster import KMeans

    torch.manual_seed(8)
    enc = pm.Encoder(1, 3, 4, 2)
    x = torch.from_numpy((np.random.RandomState(9).rand(4, SIZE, SIZE, 1)
                          * 2 - 1).astype(np.float32))
    with torch.no_grad():
        feats = enc(x).reshape(-1, 3).double().numpy()
    _, inertia = encode_features.kmeans(feats, 10)
    km = KMeans(n_clusters=10, n_init=10, random_state=0).fit(feats)
    assert inertia <= 1.01 * km.inertia_
