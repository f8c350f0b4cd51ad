"""The port's native PNG loader (``data/native_loader.py``, its own copy
of ``native/dataloader.cpp`` built into ``cistar_tpu_torch/native/build``)
and the datasets on it, against the JAX package's.

This host has g++ and libpng, so every test here asserts that the native
path ran: a silent fall back to PIL would pass a parity test by accident.

  * the port's ``NativePngLoader`` against the JAX package's on the same
    PNGs, at the frames' size and resized down and up: bit for bit (the
    same source, the same flags); against PIL's decode within 1e-5 and
    the half-pixel bilinear resize reference within 2e-5
    (``tests/test_runtime_native.py``'s budgets);
  * ``make_cyclegan_dataset`` and ``Loader``'s ``get_batch`` path against
    JAX's at the same seed, aligned and unaligned, train (with the shared
    rotation) and test: the batches bit for bit, two shuffled epochs;
  * the PIL fallback where g++ or libpng is missing, and no fallback
    for any other fault.
"""

import glob
import os
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from cistar_tpu.data import datasets as jdata
from cistar_tpu.data import native_loader as jnative
from cistar_tpu_torch.data import datasets as data
from cistar_tpu_torch.data import native_loader as native
from cistar_tpu_torch.data import transforms as T


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(0)
    for i in range(6):
        Image.fromarray((rng.rand(48, 48) * 255).astype(np.uint8)).save(
            d / f"{i}.png")
    return str(d)


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    """10 radar / lidar pairs of 40² frames (resized by the datasets)."""
    root = tmp_path_factory.mktemp("cyclegan_pngs")
    rng = np.random.RandomState(1)
    for d in ("radar", "lidar"):
        os.makedirs(root / d)
        for i in range(10):
            Image.fromarray((rng.rand(40, 40) * 255).astype(np.uint8)).save(
                root / d / f"{i:05d}.png")
    return str(root)


def _paths(d):
    return sorted(glob.glob(os.path.join(d, "*.png")))


def _native_ran():
    """The port's library was built from its own source and loaded."""
    assert native.LIB_PATH.startswith(os.path.join(
        os.path.dirname(native.__file__).rsplit(os.sep, 1)[0], "native",
        "build"))
    assert os.path.exists(native.LIB_PATH)
    assert native._lib is not None and native._lib._name == native.LIB_PATH


@pytest.mark.parametrize("size", [48, 24, 64])
def test_native_loader_matches_jax_bit_for_bit(png_dir, size):
    paths = _paths(png_dir)
    got = native.NativePngLoader(paths, size=size).get_batch([0, 3, 5, 1])
    _native_ran()
    want = jnative.NativePngLoader(paths, size=size).get_batch([0, 3, 5, 1])
    assert got.shape == (4, size, size, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_native_loader_matches_pil(png_dir):
    paths = _paths(png_dir)
    batch = native.NativePngLoader(paths, size=48).get_batch([0, 1, 2])
    _native_ran()
    for i in range(3):
        ref = T.normalize(T.pil_to_array(T.load_image(paths[i], "L")))
        np.testing.assert_allclose(batch[i], ref, rtol=0, atol=1e-5)


def test_native_loader_resize_matches_the_bilinear_reference(png_dir):
    # half-pixel point-sampled bilinear: torch's interpolate without
    # antialiasing (PIL antialiases a downscale, a different convention)
    paths = _paths(png_dir)
    batch = native.NativePngLoader(paths, size=24).get_batch([0])
    _native_ran()
    full = T.normalize(T.pil_to_array(T.load_image(paths[0], "L")))
    t = torch.from_numpy(full[None].transpose(0, 3, 1, 2))
    ref = torch.nn.functional.interpolate(
        t, size=(24, 24), mode="bilinear", align_corners=False,
        antialias=False).numpy()[0].transpose(1, 2, 0)
    np.testing.assert_allclose(batch[0], ref, rtol=0, atol=2e-5)


def test_native_loader_rejects_a_missing_file(png_dir, tmp_path):
    ldr = native.NativePngLoader([str(tmp_path / "none.png")], size=8)
    with pytest.raises(IOError, match="decoded 0/1"):
        ldr.get_batch([0])


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_native_dataset_and_loader_match_jax(pair_root, unaligned, mode):
    ds = data.make_cyclegan_dataset(pair_root, 32, unaligned, mode)
    assert isinstance(ds, data.NativeCycleGANDataset)
    _native_ran()
    jds = jdata.make_cyclegan_dataset(pair_root, 32, unaligned, mode)
    assert isinstance(jds, jdata.NativeCycleGANDataset)
    assert len(ds) == len(jds) == (5 if mode == "train" else 1)
    loader = data.Loader(ds, 2, shuffle=True)
    jloader = jdata.Loader(jds, 2, shuffle=True)
    for _ in range(2):   # two epochs: two shuffles, the rng carried on
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for a, b in zip(got, want):
            assert a["name"] == b["name"]
            for k in ("A", "B"):
                assert a[k].shape[1:] == (32, 32, 1)
                np.testing.assert_array_equal(a[k], b[k])


def test_make_cyclegan_dataset_falls_back_to_pil(pair_root, monkeypatch):
    assert type(data.make_cyclegan_dataset(pair_root, None, False, "test")) \
        is data.CycleGANImageDataset
    # no g++ or libpng: the build raises, and the PIL dataset serves
    monkeypatch.setattr(native, "_lib", None)

    def no_toolchain():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "build", no_toolchain)
    ds = data.make_cyclegan_dataset(pair_root, 32, False, "test")
    assert type(ds) is data.CycleGANImageDataset
    # g++ runs but the compile fails (no png.h): the PIL dataset serves
    monkeypatch.setattr(native, "build", lambda: (_ for _ in ()).throw(
        subprocess.CalledProcessError(1, ["g++"])))
    ds = data.make_cyclegan_dataset(pair_root, 32, False, "test")
    assert type(ds) is data.CycleGANImageDataset


def test_make_cyclegan_dataset_raises_other_faults(pair_root, monkeypatch):
    # a fault of the native dataset itself is not hidden behind PIL
    def broken(*args):
        raise ValueError("a fault of the native dataset")

    monkeypatch.setattr(data, "NativeCycleGANDataset", broken)
    with pytest.raises(ValueError, match="a fault of the native dataset"):
        data.make_cyclegan_dataset(pair_root, 32, False, "test")
