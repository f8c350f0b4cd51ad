"""The port's LPIPS metric and fidelity helpers (``cistar_tpu_torch/utils/
lpips.py``, ``utils/fidelity.py``) against the JAX package's
(``cistar_tpu/utils/lpips.py``, ``tools/fidelity_table.py``), on the same
seeded numpy NHWC inputs, fp32 on the CPU.

The distances agree within ``RTOL`` (1e-5) relative: both walk the same
seeded VGG16 (bit for bit the same weights) and differ only in the convs'
summation order: 1.9e-6 relative the largest gap measured over the
eight cases of ``test_lpips_matches_jax``, on one CPU thread.
"""

import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cistar_tpu.models import vgg as jvgg
from cistar_tpu.utils import lpips as jlpips
from cistar_tpu_torch.models import vgg as tvgg
from cistar_tpu_torch.utils import fidelity, lpips

RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (64, 128, 256, 512, 512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vgg16():
    """The seeded VGG16 of both packages (bit for bit the same)."""
    return (jvgg.init_vgg_params(jvgg.VGG16_CONVS, seed=7),
            tvgg.init_vgg_params(tvgg.VGG16_CONVS, seed=7))


@pytest.fixture(scope="module")
def fidelity_table():
    spec = importlib.util.spec_from_file_location(
        "fidelity_table", os.path.join(ROOT, "tools", "fidelity_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(seed, size, c):
    rng = np.random.RandomState(seed)
    a = rng.rand(2, size, size, c).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    return a, b


def _heads(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(c).astype(np.float32)
            for k, c in zip(lpips._LPIPS_KEYS, CHANNELS)}


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("with_heads", [False, True])
def test_lpips_matches_jax(vgg16, size, c, with_heads):
    jp, tp = vgg16
    a, b = _pair(size + c, size, c)
    heads = _heads(size * c) if with_heads else None
    want = np.asarray(jlpips.lpips_distance(
        jnp.asarray(a), jnp.asarray(b), jp,
        head_weights=heads and {k: jnp.asarray(v) for k, v in heads.items()}))
    got = lpips.lpips_distance(
        torch.from_numpy(a), torch.from_numpy(b), tp,
        head_weights=heads and {k: torch.from_numpy(v)
                                for k, v in heads.items()})
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert np.all(want > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_seeded_backbone_warns_as_jax(vgg16):
    _, tp = vgg16
    a, b = _pair(3, 32, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.warns(RuntimeWarning, match="no VGG16 weights"):
        got = lpips.lpips_distance(ta, tb)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        explicit = lpips.lpips_distance(ta, tb, tp)
    assert torch.equal(got, explicit)


@pytest.mark.parametrize("spelling", ["lin{i}.model.1.weight",
                                      "lin{i}.1.weight",
                                      "lins.{i}.model.1.weight"])
def test_load_lpips_heads_spellings(tmp_path, spelling):
    heads = _heads(11)
    sd = {spelling.format(i=i): torch.from_numpy(v).reshape(1, -1, 1, 1)
          for i, v in enumerate(heads.values())}
    sd["extra.weight"] = torch.zeros(3)
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    got = lpips.load_lpips_heads(path)
    want = jlpips.load_lpips_heads(path)
    assert list(got) == list(want) == list(lpips._LPIPS_KEYS)
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(), heads[k])


def test_load_lpips_heads_missing_layer(tmp_path):
    sd = {f"lin{i}.model.1.weight": torch.ones(1, c, 1, 1)
          for i, c in enumerate(CHANNELS) if i != 3}
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="layer 3"):
        lpips.load_lpips_heads(path)
    with pytest.raises(KeyError, match="layer 3"):
        jlpips.load_lpips_heads(path)


@pytest.mark.parametrize("batch,size,seed", [(8, 256, 0), (2, 64, 5)])
def test_make_radar_bit_for_bit(fidelity_table, batch, size, seed):
    got = fidelity.make_radar(batch, size, seed)
    want = fidelity_table.make_radar(batch, size, seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_fidelity_metric_matches_jax(fidelity_table):
    assert fidelity.BUDGET == fidelity_table.BUDGET == 1e-2
    ref = fidelity.make_radar(2, 32)
    rng = np.random.RandomState(1)
    out = np.clip(ref + 0.05 * rng.randn(*ref.shape), -1, 1).astype(
        np.float32)
    with pytest.warns(RuntimeWarning):
        got = fidelity.fidelity_metric(torch.from_numpy(ref),
                                       torch.from_numpy(out))
    with pytest.warns(RuntimeWarning):
        want = fidelity_table._metric(ref, out)
    assert set(got) == set(want) == {"lpips_metric", "pixel_l1"}
    for k in got:
        # _metric rounds to 8 decimals: half a unit of that on top
        assert abs(got[k] - want[k]) <= RTOL * abs(want[k]) + 5e-9, k
    assert 0 < got["lpips_metric"] and 0 < got["pixel_l1"]


def test_lpips_zero_for_identical(vgg16):
    a = torch.from_numpy(np.random.RandomState(0).rand(
        2, 32, 32, 1).astype(np.float32))
    np.testing.assert_allclose(lpips.lpips_distance(a, a, vgg16[1]).numpy(),
                               0.0, atol=1e-6)


def test_lpips_monotonic_in_noise(vgg16):
    a = torch.from_numpy(np.random.RandomState(0).rand(
        1, 64, 64, 1).astype(np.float32))
    d_small = float(lpips.lpips_distance(a, a + 0.01, vgg16[1])[0])
    d_large = float(lpips.lpips_distance(a, a + 0.2, vgg16[1])[0])
    assert 0 < d_small < d_large
