"""Reference checkpoint import (``cistar_tpu_torch/core/torch_import.py``,
``core/convert_models.py``, ``apps/convert_checkpoint.py``) against the JAX
package's (``cistar_tpu/core/torch_import.py``, ``core/convert_models.py``,
``apps/convert_checkpoint.py``).

The ``state_dict`` s come from the torch twins of the reference networks
(``tools/reference_twins.py``) or, for the families the repo has no twin
of, are random arrays under exactly the keys and shapes that the JAX
converter's own prefix map reads (recorded from it). Every converter and
the CLI's ``.npz`` equal JAX's bit for bit; each ``*_from_pth`` equals
JAX's converter followed by the port's ``*_from_jax``; a twin's fp32
forward and the port module loaded from its ``.pth`` agree within
``TWIN_ATOL`` (1e-5; both are torch fp32 on the CPU, and the largest gap
measured here is 1.9e-6, at the ResNet generator).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from cistar_tpu.apps import convert_checkpoint as jcli
from cistar_tpu.core import checkpoint as jckpt
from cistar_tpu.core import convert_models as jcm
from cistar_tpu.core import torch_import as jti
from cistar_tpu_torch.apps import convert_checkpoint as tcli
from cistar_tpu_torch.apps import cyclegan_test, p2phd_test
from cistar_tpu_torch.apps import p2phd_options
from cistar_tpu_torch.core import checkpoint as tckpt
from cistar_tpu_torch.core import convert as tcv
from cistar_tpu_torch.core import convert_models as tcm
from cistar_tpu_torch.core import torch_import as tti
from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
from cistar_tpu_torch.models import cyclegan as pcg
from cistar_tpu_torch.models import pix2pixhd as pp
from cistar_tpu_torch.models import vgg as tvgg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_TXT = os.path.join(ROOT, "checkpoints", "r2l_MSRB_7", "opt.txt")
TWIN_ATOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # importable by name: pickles name its classes
    spec.loader.exec_module(mod)
    return mod


tw = _load("reference_twins")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def assert_trees_equal(got, want):
    """Same keys, dtypes and bits."""
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        g, w = np.asarray(fg[k]), np.asarray(fw[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


# --------------------------------------------------------------------------- #
# families with a torch twin
# --------------------------------------------------------------------------- #
# name → (twin, port module, JAX converter, port from_pth, port from_jax,
#         input (N, H, W, C))
TWINS = {
    "cyclegan_p2p": (
        lambda: tw.seeded(tw.CycleResnetG, n_res=2, nf=8),
        lambda: pcg.build_generator("p2p", 1, 1, 8, 2),
        lambda cm, sd: cm.convert_cyclegan_generator(sd, "p2p", 2),
        lambda sd: tcm.cyclegan_generator_from_pth(sd, "p2p", 2),
        tcv.resnet_generator_from_jax, (1, 32, 32, 1)),
    "cyclegan_d": (
        lambda: tw.seeded(tw.CycleD),
        pcg.PatchDiscriminator,
        lambda cm, sd: cm.convert_cyclegan_discriminator(sd),
        tcm.cyclegan_discriminator_from_pth,
        tcv.patch_discriminator_from_jax, (2, 64, 64, 1)),
    **{f"cyclegan_{kind}": (
        lambda kind=kind: tw.seeded(tw.SkipDecoderG, kind=kind, n_res=1,
                                    nf=8),
        lambda gt=gt: pcg.build_generator(gt, 1, 1, 8, 1,
                                          dense_decoder=False),
        lambda cm, sd, gt=gt: cm.convert_cyclegan_generator(
            sd, gt, 1, dense_decoder=False),
        lambda sd, gt=gt: tcm.cyclegan_generator_from_pth(
            sd, gt, 1, dense_decoder=False),
        tcv.generator_from_jax, (1, 32, 32, 1))
        for kind, gt in (("unet", "unet_content"), ("atrous", "atrous_x"),
                         ("bilinear", "bilinear_content"))},
    "p2phd_global": (
        lambda: tw.seeded(tw.GlobalG),
        lambda: pp.GlobalGenerator(1, 1, 8, 2, 2),
        lambda cm, sd: cm.convert_p2phd_generator(
            sd, "global", n_downsample_global=2, n_blocks_global=2),
        lambda sd: tcm.p2phd_generator_from_pth(
            sd, "global", n_downsample_global=2, n_blocks_global=2),
        tcv.global_generator_from_jax, (1, 32, 32, 1)),
    "p2phd_local": (
        lambda: tw.seeded(tw.LocalEnhancerT),
        lambda: pp.LocalEnhancer(1, 1, 4, 2, 2, 1, 1),
        lambda cm, sd: cm.convert_p2phd_generator(
            sd, "local", n_downsample_global=2, n_blocks_global=2,
            n_blocks_local=1),
        lambda sd: tcm.p2phd_generator_from_pth(
            sd, "local", n_downsample_global=2, n_blocks_global=2,
            n_blocks_local=1),
        tcv.local_enhancer_from_jax, (1, 64, 64, 1)),
    "p2phd_unet": (
        lambda: tw.seeded(tw.UNetHD, n_res=2, nf=8),
        lambda: pp.UNetGeneratorHD(1, 1, 2, 8),
        lambda cm, sd: cm.convert_p2phd_generator(sd, "UNet",
                                                  n_blocks_global=2),
        lambda sd: tcm.p2phd_generator_from_pth(sd, "UNet",
                                                n_blocks_global=2),
        tcv.unet_generator_hd_from_jax, (1, 32, 32, 1)),
    "p2phd_d": (
        lambda: tw.seeded(tw.MultiscaleD),
        lambda: pp.MultiscaleDiscriminator(2, 8, 3, num_D=2,
                                           get_interm_feat=True),
        lambda cm, sd: cm.convert_multiscale_discriminator(sd, 2, 3),
        lambda sd: tcm.multiscale_discriminator_from_pth(sd, 2, 3),
        tcv.multiscale_discriminator_from_jax, (1, 64, 64, 2)),
}


def _outputs(y, twin: bool):
    """A forward's tensors, NHWC, flattened out of the D's lists."""
    if isinstance(y, list):
        return [t for scale in y for t in _outputs(scale, twin)]
    if twin and y.dim() == 4:
        y = tw.nhwc(y)
    elif twin and y.dim() == 2:   # CycleGAN D's (N, 1) view: the port's (N,)
        y = y.reshape(-1)
    return [y]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_converters_match_jax(name):
    twin, _, convert, from_pth, from_jax, _ = TWINS[name]
    sd = tw.numpy_state_dict(twin())
    want = convert(jcm, sd)
    assert_trees_equal(convert(tcm, sd), want)
    assert_sd_equal(from_pth(sd), from_jax(want))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_forward_matches_port_from_pth(name, tmp_path):
    make_twin, make_port, _, from_pth, _, shape = TWINS[name]
    twin = make_twin()
    path = str(tmp_path / "net.pth")
    torch.save(twin.state_dict(), path)
    port = make_port().eval()
    port.load_state_dict(from_pth(tti.load_state_dict(path)))
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    with torch.no_grad():
        want = _outputs(twin(tw.nchw(x)), True)
        got = _outputs(port(torch.from_numpy(x)), False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert (g - w).abs().max().item() <= TWIN_ATOL


@pytest.mark.parametrize("name", ["cyclegan_bilinear", "p2phd_unet"])
def test_one_pass_twin_matches_port(name):
    # the twin with the port's one-pass instance-norm moments: the same
    # function as nn.InstanceNorm2d's twin, rounded as the port rounds it
    make_twin, make_port, _, from_pth, _, shape = TWINS[name]
    twin = make_twin()
    one_pass = tw.with_one_pass_norms(twin)
    assert not any(isinstance(m, torch.nn.InstanceNorm2d)
                   for m in one_pass.modules())
    port = make_port().eval()
    port.load_state_dict(from_pth(tw.numpy_state_dict(twin)))
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    with torch.no_grad():
        y = port(torch.from_numpy(x))
        for t in (twin, one_pass):
            assert (tw.nhwc(t(tw.nchw(x))) - y).abs().max().item() \
                <= TWIN_ATOL


# --------------------------------------------------------------------------- #
# families without a twin: the keys the JAX converter's prefix map reads
# --------------------------------------------------------------------------- #
def _record_maps(monkeypatch, convert):
    """The (prefix, targets) lists the JAX converter hands to its mapper."""
    maps = []

    def by_map(sd, prefix_map):
        maps.extend(prefix_map)
        return {}

    def with_norms(sd, prefix_map):
        maps.extend(prefix_map)
        return {}, {}

    monkeypatch.setattr(jcm, "_convert_by_map", by_map)
    monkeypatch.setattr(jcm, "_convert_with_norms", with_norms)
    convert(jcm, {})
    monkeypatch.undo()
    return maps


def _node(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _reference_sd(maps, tree, seed):
    """Random reference-layout arrays for ``maps``, each key's shape that of
    the port module's counterpart (``tree``, its JAX-layout params)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for prefix, targets in maps:
        for j, (path, kind) in enumerate(targets):
            base, node = f"{prefix}.{j}", _node(tree, path)
            if kind in ("conv", "convT"):
                w = node["w"]
                shape = (w.shape[3], w.shape[2], *w.shape[:2]) \
                    if kind == "conv" else (w.shape[2], w.shape[3],
                                            *w.shape[:2])
                sd[base + ".weight"] = rng.randn(*shape).astype(np.float32)
                if "b" in node:
                    sd[base + ".bias"] = rng.randn(
                        *node["b"].shape).astype(np.float32)
                continue
            c = node["gamma"].shape
            sd[base + ".weight"] = (1 + 0.1 * rng.randn(*c)).astype(
                np.float32)
            sd[base + ".bias"] = rng.randn(*c).astype(np.float32)
            if kind == "bn":
                sd[base + ".running_mean"] = rng.randn(*c).astype(np.float32)
                sd[base + ".running_var"] = rng.rand(*c).astype(
                    np.float32) + 0.5
    return sd


# name → (port module, JAX converter, port from_pth, port from_jax)
NO_TWIN = {
    "cyclegan_atrous_dense": (
        lambda: pcg.build_generator("atrous_content", 1, 1, 8, 1,
                                    dense_decoder=True),
        lambda cm, sd: cm.convert_cyclegan_generator(sd, "atrous_content", 1,
                                                     dense_decoder=True),
        lambda sd: tcm.cyclegan_generator_from_pth(sd, "atrous_content", 1,
                                                   dense_decoder=True),
        tcv.generator_from_jax),
    "multiscale": (
        lambda: pp.MultiscaleGlobalGenerator(1, 1, 4, 2),
        lambda cm, sd: cm.convert_multiscale_global_generator(sd, 2),
        lambda sd: tcm.p2phd_generator_from_pth(sd, "multiscale",
                                                n_blocks_global=2),
        lambda out: tcv.multiscale_global_generator_from_jax(*out)),
    "autoencoder": (
        lambda: pp.AutoEncoder(1, 1, 4, 2, 2),
        lambda cm, sd: cm.convert_autoencoder(sd, 2, 2),
        lambda sd: tcm.p2phd_generator_from_pth(
            sd, "autoencoder", n_downsample_global=2, n_blocks_global=2),
        lambda out: tcv.generator_from_jax(out, batch_stats={})),
    "encoder": (
        lambda: pp.Encoder(1, 3, 4, 2),
        lambda cm, sd: cm.convert_p2phd_encoder(sd, 2),
        lambda sd: tcm.p2phd_generator_from_pth(sd, "encoder",
                                                n_downsample_global=2),
        tcv.encoder_from_jax),
    "wdiscriminator": (
        lambda: pp.WDiscriminator(1, 4, 4),
        lambda cm, sd: cm.convert_wdiscriminator(sd, 4),
        lambda sd: tcm.wdiscriminator_from_pth(sd, 4),
        lambda out: tcv.generator_from_jax(out, batch_stats={})),
    "uda_encoder": (
        lambda: pp.UDAEncoder(1, 32, 2, 4, 2),
        lambda cm, sd: cm.convert_uda_encoder(sd, 2, 2),
        lambda sd: tcm.uda_encoder_from_pth(sd, 2, 2),
        lambda out: tcv.generator_from_jax(out[0], batch_stats=out[1])),
    "uda_decoder": (
        lambda: pp.UDADecoder(8, 1, 2, 2),
        lambda cm, sd: cm.convert_uda_decoder(sd, 2, 2),
        lambda sd: tcm.uda_decoder_from_pth(sd, 2, 2),
        lambda out: tcv.generator_from_jax(out[0], batch_stats=out[1])),
    "uda_domain_d": (
        lambda: pp.DomainFeatureDiscriminator(16, 4),
        lambda cm, sd: cm.convert_domain_feature_discriminator(sd),
        tcm.domain_feature_discriminator_from_pth,
        lambda out: tcv.generator_from_jax(out[0], batch_stats=out[1])),
    "transfer_generator": (
        lambda: pp.TransferGenerator(1, 2, 4, 2),
        lambda cm, sd: cm.convert_transfer_generator(sd, 2, 2),
        lambda sd: tcm.transfer_generator_from_pth(sd, 2, 2),
        tcv.generator_from_jax),
}


def no_twin_sd(name, monkeypatch, seed=0):
    make_port, convert, _, _ = NO_TWIN[name]
    port = make_port()
    tree = tcv.generator_to_jax(port.state_dict())
    return port, _reference_sd(_record_maps(monkeypatch, convert), tree,
                               seed)


@pytest.mark.parametrize("name", sorted(NO_TWIN))
def test_converters_match_jax_on_the_prefix_maps(name, monkeypatch):
    port, sd = no_twin_sd(name, monkeypatch)
    _, convert, from_pth, from_jax = NO_TWIN[name]
    want = convert(jcm, sd)
    got = convert(tcm, sd)
    if isinstance(want, tuple):   # (params, batch_stats)
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            assert_trees_equal(g, w)
    else:
        assert_trees_equal(got, want)
    sd_port = from_pth(sd)
    assert_sd_equal(sd_port, from_jax(want))
    port.load_state_dict(sd_port)   # strict: every key, every shape


def test_uda_encoder_linear_head_is_not_converted(monkeypatch):
    # JAX's convert_uda_encoder maps the conv trunk only, and so does its
    # copy: a linear encoder's state_dict lacks linear_w / linear_b
    _, sd = no_twin_sd("uda_encoder", monkeypatch)
    got = tcm.uda_encoder_from_pth(sd, 2, 2)
    assert not {"linear_w", "linear_b"} & set(got)
    with pytest.raises(RuntimeError, match="linear_w"):
        pp.UDAEncoder(1, 32, 2, 4, 2, linear=True).load_state_dict(got)


def test_feature_encoder_numbered_format_matches_jax():
    port = pp.FeatureEncoder(1, 4, n_downsampling=3, n_scale=2)
    tree = tcv.generator_to_jax(port.state_dict())
    rng = np.random.RandomState(4)

    def conv(path):
        w = _node(tree, path)["w"]
        return (rng.randn(w.shape[3], w.shape[2], *w.shape[:2]).astype(
            np.float32), rng.randn(w.shape[3]).astype(np.float32))

    w, b = conv("stem/conv")
    # each branch wraps the shared first layer (pad, conv, norm, ReLU)
    numbered = {str(i): {"1.weight": w, "1.bias": b} for i in range(2)}
    for i in range(3):
        w, b = conv(f"down_{i}/conv")
        numbered[str(2 + i)] = {"0.weight": w, "0.bias": b}
    want = jcm.convert_feature_encoder(numbered, 3, 2)
    assert_trees_equal(tcm.convert_feature_encoder(numbered, 3, 2), want)
    sd = tcm.feature_encoder_from_pth(numbered, 3, 2)
    assert_sd_equal(sd, tcv.generator_from_jax(want))
    port.load_state_dict(sd)


# --------------------------------------------------------------------------- #
# load_state_dict
# --------------------------------------------------------------------------- #
def test_load_state_dict_non_tensor_values(tmp_path):
    path = str(tmp_path / "sd.pth")
    torch.save({"conv.weight": torch.randn(2, 1, 3, 3), "epoch": 7,
                "lr": 2e-4, "shape": [1, 2]}, path)
    got, want = tti.load_state_dict(path), jti.load_state_dict(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_load_state_dict_pickled_module(tmp_path):
    twin = tw.seeded(tw.GlobalG)
    path = str(tmp_path / "net.pth")
    torch.save(twin, path)
    # weights_only: a pickled module's classes must be allowed by the caller
    for mod in (tti, jti):
        with pytest.raises(Exception, match="Weights only load failed"):
            mod.load_state_dict(path)
    classes = [type(m) for m in twin.modules()]
    with torch.serialization.safe_globals(classes):
        got, want = tti.load_state_dict(path), jti.load_state_dict(path)
    assert_trees_equal(got, want)
    assert_trees_equal(got, tw.numpy_state_dict(twin))


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #
def _vgg_sd(convs, spelling):
    """Random VGG weights (4-channel stages) in a reference layout."""
    rng = np.random.RandomState(len(convs))
    width = {c[0]: min(4 * 2 ** (int(c[0][4]) - 1), 16) for c in convs}
    cin = {n: 3 if i == 0 else width[convs[i - 1][0]]
           for i, (n, _, _) in enumerate(convs)}
    if spelling == "bethge":
        keys = {n: n for n, _, _ in convs}
    else:
        seq = tvgg.VGG19_FORWARD_SEQ if len(convs) == 16 \
            else tvgg.VGG16_FORWARD_SEQ
        keys, idx = {}, 0
        for n in seq:
            if n.startswith("pool"):
                idx += 1
            else:
                keys[n] = f"{spelling}{idx}"
                idx += 2
    sd = {}
    for n, _, _ in convs:
        sd[keys[n] + ".weight"] = torch.from_numpy(rng.randn(
            width[n], cin[n], 3, 3).astype(np.float32))
        sd[keys[n] + ".bias"] = torch.from_numpy(rng.randn(width[n]).astype(
            np.float32))
    return sd


def _family_pth(family, tmp_path, monkeypatch):
    """(state_dict to save, CLI flags) for ``family``."""
    if family == "cyclegan-g":
        twin = tw.seeded(tw.SkipDecoderG, kind="bilinear", n_res=2, nf=8)
        return twin.state_dict(), ["--gen_type", "bilinear_content",
                                   "--n_residual_blocks", "2"]
    if family == "cyclegan-d":
        return tw.seeded(tw.CycleD).state_dict(), []
    if family == "p2phd-g":
        return tw.seeded(tw.UNetHD, n_res=2, nf=8).state_dict(), [
            "--netG", "UNet", "--n_blocks_global", "2"]
    if family == "p2phd-g-multiscale":
        _, sd = no_twin_sd("multiscale", monkeypatch)
        return sd, ["--netG", "multiscale", "--n_blocks_global", "2"]
    if family == "p2phd-d":
        return tw.seeded(tw.MultiscaleD).state_dict(), []
    if family == "p2phd-wd":   # n_layer = n_layers_D + 2
        maps = _record_maps(monkeypatch,
                            lambda cm, s: cm.convert_wdiscriminator(s, 5))
        tree = tcv.generator_to_jax(pp.WDiscriminator(1, 4, 5).state_dict())
        return _reference_sd(maps, tree, 5), []
    if family.startswith("uda-"):
        name = {"uda-encoder": "uda_encoder", "uda-decoder": "uda_decoder",
                "uda-domain-d": "uda_domain_d"}[family]
        _, sd = no_twin_sd(name, monkeypatch)
        return sd, ["--n_downsample_global", "2", "--n_blocks_global", "2"]
    if family == "vgg19-conv":
        return _vgg_sd(tvgg.VGG19_CONVS, "bethge"), []
    if family == "vgg19-features":
        return _vgg_sd(tvgg.VGG19_CONVS, "features."), []
    return _vgg_sd(tvgg.VGG16_CONVS, ""), []


@pytest.mark.parametrize("family", tcli.FAMILIES + ["p2phd-g-multiscale"])
def test_cli_writes_the_jax_npz(family, tmp_path, monkeypatch, capsys):
    sd, flags = _family_pth(family, tmp_path, monkeypatch)
    pth = str(tmp_path / "in.pth")
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, pth)
    fam = family.replace("-multiscale", "")
    args = ["--family", fam, "--in_pth", pth, *flags]
    tcli.main(args + ["--out", str(tmp_path / "port.npz")])
    port_line = capsys.readouterr().out
    jcli.main(args + ["--out", str(tmp_path / "jax.npz")])
    jax_line = capsys.readouterr().out
    assert port_line.replace("port.npz", "jax.npz") == jax_line
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") \
            as j:
        assert sorted(p.files) == sorted(j.files) and p.files
        for k in j.files:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape
            assert p[k].tobytes() == j[k].tobytes(), k
    assert_trees_equal(jckpt.load_pytree(str(tmp_path / "port.npz")),
                       tckpt.load_pytree(str(tmp_path / "jax.npz")))


# --------------------------------------------------------------------------- #
# the test CLIs serve a converted checkpoint
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("r2l"))
    _load("make_synthetic_r2l").main(["--out", root, "--n", "4", "--size",
                                      "32"])
    return root


def _png01(path):
    return np.asarray(Image.open(path), np.float32) / 255.0


@pytest.mark.parametrize("data_type", [32, 8])
def test_p2phd_test_serves_a_converted_checkpoint(pairs, tmp_path,
                                                  data_type):
    twin = tw.seeded(tw.UNetHD, n_res=2, nf=8)
    pth = str(tmp_path / "latest_net_G.pth")
    torch.save(twin.state_dict(), pth)
    run = tmp_path / "ck" / "r2l_MSRB_7"
    tcli.main(["--family", "p2phd-g", "--netG", "UNet", "--n_blocks_global",
               "2", "--in_pth", pth, "--out", str(run / "latest_net_G.npz")])
    args = ["--load_opt", OPT_TXT, "--dataroot", pairs, "--r2l_res", "32",
            "--ngf", "8", "--n_blocks_global", "2", "--checkpoints_dir",
            str(tmp_path / "ck"), "--results_dir", str(tmp_path / "res"),
            "--phase", "test", "--how_many", "1", "--device", "cpu",
            "--data_type", str(data_type)]
    web = p2phd_test.main(args)
    pngs = sorted(os.listdir(os.path.join(web, "images")))
    synth = [p for p in pngs if p.endswith("_synthesized_image.png")]
    assert len(synth) == 1
    # the frame the CLI read, through the twin
    from cistar_tpu_torch.data.datasets import Radar2LidarDataset
    label = Radar2LidarDataset(pairs, size=32, mode="test")[0]["label"]
    with torch.no_grad():
        want = tw.nhwc(twin(tw.nchw(label[None])))[0, ..., 0].numpy()
    got = _png01(os.path.join(web, "images", synth[0]))
    err = np.abs(got - np.clip(want * 0.5 + 0.5, 0, 1)).max()
    # fp32: one PNG step; int8: the engine's error against fp32 on top
    # (0.011 measured)
    assert err <= (1 / 255 + 1e-6 if data_type == 32 else 0.05), err


@pytest.mark.parametrize("engine", ["default", "int8"])
def test_cyclegan_test_serves_a_converted_pair(pairs, tmp_path, engine):
    # the CLI's generators: bilinear_content, 16 features, 6 blocks
    model_dir = tmp_path / "run"
    twins = {}
    for seed, net in enumerate(("netG_A2B", "netG_B2A", "netD_A", "netD_B")):
        gen = net.startswith("netG")
        twins[net] = tw.seeded(tw.SkipDecoderG, seed, kind="bilinear",
                               n_res=6, nf=16) if gen \
            else tw.seeded(tw.CycleD, seed)
        pth = str(tmp_path / f"{net}.pth")
        torch.save(twins[net].state_dict(), pth)
        tcli.main(["--family", "cyclegan-g" if gen else "cyclegan-d",
                   "--gen_type", "bilinear_content", "--in_pth", pth,
                   "--out", str(model_dir / f"{net}.npz")])
    save_dir = cyclegan_test.main(
        ["--dataroot", pairs, "--model_dir", str(model_dir), "--size", "32",
         "--gen_type", "bilinear_content", "--engine", engine, "--dtype",
         "fp32", "--device", "cpu"])
    from cistar_tpu_torch.data.datasets import CycleGANImageDataset
    item = CycleGANImageDataset(pairs, size=32, mode="test")[0]
    with torch.no_grad():
        fake_a = twins["netG_B2A"](tw.nchw(item["B"][None]))
        rec_b = tw.nhwc(twins["netG_A2B"]((fake_a - 0.5) / 0.5))
    want = np.clip(rec_b[0, ..., 0].numpy() * 0.5 + 0.5, 0, 1)
    got = _png01(os.path.join(save_dir, item["name"]))
    err = np.abs(got - want).max()
    # fp32: one PNG step; int8: the engine's error against fp32 on top
    # (0.025 measured)
    assert err <= (1 / 255 + 1e-6 if engine == "default" else 0.05), err


# --------------------------------------------------------------------------- #
# a gap of the reference: the converted multiscale file
# --------------------------------------------------------------------------- #
def test_converted_multiscale_file_loads_nothing_into_g(tmp_path,
                                                        monkeypatch):
    """Both packages' CLIs write a BatchNorm family as one ``{"params",
    "batch_stats"}`` tree, while both ``p2phd_test`` s load G and G_stats
    from two files, G through the tolerant merge: every key of the
    converted file is an extra key there, so G keeps its initial weights
    without a word, and the G_stats file is one no CLI writes."""
    _, sd = no_twin_sd("multiscale", monkeypatch)
    pth = str(tmp_path / "latest_net_G.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    run = tmp_path / "ck" / "r2l"
    tcli.main(["--family", "p2phd-g", "--netG", "multiscale",
               "--n_blocks_global", "2", "--in_pth", pth,
               "--out", str(run / "latest_net_G.npz")])
    eng = Pix2PixHDInference("multiscale", ngf=4, n_blocks_global=2,
                             device="cpu")
    like = eng.jax_params()["G"]
    assert set(tckpt.load_pytree(str(run / "latest_net_G.npz"))) == \
        {"params", "batch_stats"}
    for mod in (tckpt, jckpt):
        g = mod.load_network(str(run), "G", "latest", like)
        assert_trees_equal({k: np.asarray(v) for k, v in _flat(g).items()},
                           _flat(like))
        with pytest.raises(FileNotFoundError):
            mod.load_network(str(run), "G_stats", "latest",
                             eng.jax_params()["G_stats"])
    opt = p2phd_options.TestOptions().parse(
        ["--name", "r2l", "--checkpoints_dir", str(tmp_path / "ck"),
         "--netG", "multiscale", "--ngf", "4", "--n_blocks_global", "2",
         "--device", "cpu", "--dataroot", str(tmp_path)], save=False)
    with pytest.raises(FileNotFoundError, match="G_stats"):
        p2phd_test.load_engine(opt)
    # the weights are there, under "params" / "batch_stats"
    tree = tckpt.load_pytree(str(run / "latest_net_G.npz"))
    eng.load_jax_params(tree["params"], tree["batch_stats"])
    assert_sd_equal({k: v for k, v in eng.G.state_dict().items()
                     if not k.endswith("num_batches_tracked")},
                    tcm.p2phd_generator_from_pth(sd, "multiscale",
                                                 n_blocks_global=2))
