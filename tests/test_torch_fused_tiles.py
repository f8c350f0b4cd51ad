"""The schedules of K9 and K4 on Hopper (``csrc/head_cout1.cu``,
``csrc/in_act.cu``) on the CPU: numpy / torch models of what each kernel
computes, tile by tile and rank by rank, against the port's plain versions
(``ops/fused.py``) and the JAX package's Pallas kernels in interpret mode,
and the Python mirrors of the two launches (``kernels/head_cout1.py``,
``kernels/in_act.py``) at every path shape.

K9's model is ``head_tc_kernel``'s: 16 × 26 output tiles, each staging a
22 × 32 halo of the input through the reflect index of the loader (rows and
columns further out than 3 clamped), 64 channels a chunk; plane dx of the
halo rows, P_dx[y, x] = sum over dy and the channels of halo[y + dy, x] ·
w[dy, dx] (the bf16 tap matmul, fp32 sums); then out[y, x] = sum over dx of
P_dx[y, x + dx] in dx order from 0.0, + b, tanh, one cast. K4's model is
``in_act_cluster_kernel``'s: a cluster of ``variant`` CTAs an (image,
channel slice); rank r sums the pixels of its share (each thread's pixels
in order, then the thread rows in order), and every CTA adds the ranks'
sums in rank order; the same for the centered sum of squares.

The CUDA kernels themselves are compared with the plain versions on the
card by ``chip_smoke.py``.
"""

import functools
import re
from pathlib import Path

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.ops import head_conv as jhc
from cistar_tpu.ops import pallas_kernels as jpk
from cistar_tpu_torch.core.convert import conv_w_from_hwio
from cistar_tpu_torch.kernels import head_cout1 as kh
from cistar_tpu_torch.kernels import in_act as kn
from cistar_tpu_torch.ops import fused
from cistar_tpu_torch.ops.head_conv import head_conv_tanh_pallas

CSRC = Path(__file__).resolve().parent.parent / "cistar_tpu_torch" / "csrc"
BF16_ULP = 2.0 ** -7
# chip_smoke's K9_PRE_ABS: with pre_in, statistics summed in another order
# can round a normalized input to the neighbouring bf16 value
K9_PRE_ABS = 4e-3
# the shared memory of an H100 SM and of one block (bytes)
SM_SMEM, BLOCK_SMEM, RESERVED = 233_472, 232_448, 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Tpu:
    platform = "tpu"


@pytest.fixture
def tpu_interpret(monkeypatch):
    """The JAX package's TPU routing, its Pallas kernels interpreted (K4
    takes no ``interpret`` flag): both undone after the test."""
    orig = jpl.pallas_call

    @functools.wraps(orig)
    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpl, "pallas_call", call)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Tpu()])


def _within(got, ref, dtype, atol=1e-5, extra=0.0):
    """fp32: within ``atol``. bf16: within one bf16 ulp of the reference
    (+ 1e-6 for values within an fp32 rounding of 0, + ``extra``)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    else:
        over = np.abs(got - ref) - (BF16_ULP * np.abs(ref) + 1e-6 + extra)
        assert over.max() <= 0, over.max()


# --------------------------------------------------------------------------- #
# K9: the tensor-core tap matmul, tile by tile
# --------------------------------------------------------------------------- #
def _reflect3(v: np.ndarray, n: int) -> np.ndarray:
    """``reflect3``: ReflectionPad2d(3)'s index, clamped further out."""
    v = np.where(v < 0, -v, np.where(v >= n, 2 * n - 2 - v, v))
    return np.clip(v, 0, n - 1)


def _k9_model(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: str,
              pre_in: bool, eps: float = 1e-5) -> torch.Tensor:
    """``head_tc_kernel`` on bf16 NHWC ``x``, OIHW (1, C, 7, 7) ``w``."""
    n, h, wd, c = x.shape
    xf = x.float()
    if pre_in:
        # sums_kernel + stats_kernel: sum and sum of squares, then the mean
        # and 1 / sqrt(max(E[x^2] - mean^2, 0) + eps), IEEE in fp32
        hw = torch.tensor(float(h * wd))
        m = xf.sum(dim=(1, 2), keepdim=True) / hw
        var = torch.clamp((xf * xf).sum(dim=(1, 2), keepdim=True) / hw
                          - m * m, min=0.0)
        rs = 1.0 / torch.sqrt(var + eps)
        xf = torch.relu((xf - m) * rs).to(torch.bfloat16).float()
    taps = w[0].to(torch.bfloat16).float().permute(1, 2, 0)   # (dy, dx, c)
    th, tw, sh, sw = kh.TILE_H, kh.TILE_W, kh.SPAN_H, kh.SPAN_W
    out = torch.empty(n, h, wd, 1)
    for img in range(n):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, tw):
                ys = _reflect3(np.arange(y0 - 3, y0 - 3 + sh), h)
                xs = _reflect3(np.arange(x0 - 3, x0 - 3 + sw), wd)
                halo = xf[img][torch.from_numpy(ys)][:, torch.from_numpy(xs)]
                planes = torch.zeros(th, sw, 7)               # P_dx[y, x]
                for c0 in range(0, c, kh.CHUNK):
                    for dy in range(7):
                        planes += halo[dy:dy + th, :, c0:c0 + kh.CHUNK] \
                            @ taps[dy, :, c0:c0 + kh.CHUNK].T
                y = torch.zeros(th, tw)
                for dx in range(7):
                    y = y + planes[:, dx:dx + tw, dx]
                y = y + b.float()
                if act == "tanh":
                    y = torch.tanh(y)
                hh, ww = min(th, h - y0), min(tw, wd - x0)
                out[img, y0:y0 + hh, x0:x0 + ww, 0] = y[:hh, :ww]
    return out.to(torch.bfloat16)


def _k9_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    n, h, wd, c = shape
    x = (1.2 * rng.randn(*shape) + 0.3).astype(np.float32)
    w = (0.05 * rng.randn(7, 7, c, 1)).astype(np.float32)        # HWIO
    b = (0.1 * rng.randn(1)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return x, w, b, xt, torch.from_numpy(conv_w_from_hwio(w)), \
        torch.from_numpy(b)


# ragged edge tiles in both dimensions (20 = 16 + 4 rows, 30 = 26 + 4
# columns), a whole tile at 128 channels (two chunks), and H = W = 4
K9_SHAPES = [(1, 20, 30, 64), (1, 16, 26, 128), (2, 4, 4, 64)]
# head_conv_tanh_pallas takes H, W > 6: its smallest image is 7 x 9
K9D_SHAPES = [(1, 20, 30, 64), (1, 16, 26, 128), (2, 7, 9, 64)]


@pytest.mark.parametrize("pre_in", [False, True])
@pytest.mark.parametrize("shape", K9_SHAPES)
def test_k9_schedule_matches_plain(shape, pre_in):
    # the model and the plain version sum the same exact products in fp32
    # in other orders: within one bf16 ulp
    _, _, _, xt, wt, bt = _k9_inputs(shape, sum(shape) + pre_in)
    got = _k9_model(xt, wt, bt, "tanh", pre_in)
    ref = fused.conv2d_reflect_cout1_plain(xt, wt, bt, "tanh", pre_in)
    assert got.dtype == torch.bfloat16 and got.shape == (*shape[:3], 1)
    _within(got, ref, torch.bfloat16)


@pytest.mark.parametrize("act", ["tanh", "none"])
@pytest.mark.parametrize("shape", K9_SHAPES)
def test_k9_schedule_matches_jax_k9a(shape, act):
    # JAX's conv2d_reflect_cout1 (K9a) in interpret mode: fp32 sums in
    # another order, within one bf16 ulp
    x, w, b, xt, wt, bt = _k9_inputs(shape, sum(shape) + len(act))
    ref = jpk.conv2d_reflect_cout1(jnp.asarray(x).astype(jnp.bfloat16),
                                   jnp.asarray(w), jnp.asarray(b), act=act,
                                   interpret=True)
    _within(_k9_model(xt, wt, bt, act, False), ref, torch.bfloat16)


@pytest.mark.parametrize("pre_in", [False, True])
@pytest.mark.parametrize("shape", K9D_SHAPES)
def test_k9_schedule_matches_jax_head_kernel(shape, pre_in):
    # JAX's head_conv_tanh_pallas (K9d) in interpret mode; with pre_in its
    # own statistics may round a normalized input to the neighbouring bf16
    # value, so one ulp + K9_PRE_ABS (chip_smoke's rule), else one ulp
    x, w, b, xt, wt, bt = _k9_inputs(shape, sum(shape) + 7 * pre_in)
    ref = jhc.head_conv_tanh_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                    jnp.asarray(w), jnp.asarray(b),
                                    act="tanh", pre_in=pre_in,
                                    interpret=True)
    _within(_k9_model(xt, wt, bt, "tanh", pre_in), ref, torch.bfloat16,
            extra=K9_PRE_ABS if pre_in else 0.0)


def test_k9_halo_index_reflects_and_clamps():
    # the loader's index: ReflectionPad2d(3) within 3 of the image, clamped
    # beyond (those halo pixels feed only outputs past the edge)
    assert list(_reflect3(np.arange(-3, 8), 5)) == [3, 2, 1, 0, 1, 2, 3, 4,
                                                    3, 2, 1]
    assert list(_reflect3(np.arange(-3, 19), 4)) == \
        [3, 2, 1, 0, 1, 2, 3, 2, 1, 0] + [0] * 12


# --------------------------------------------------------------------------- #
# K4: the cluster's split and its sums in rank order
# --------------------------------------------------------------------------- #
def _seq_sum(v: np.ndarray) -> np.ndarray:
    """fp32 sums over axis 0, one term after another from 0."""
    if len(v) == 0:
        return np.zeros(v.shape[1:], np.float32)
    return np.cumsum(v, axis=0, dtype=np.float32)[-1]


def _cta_sum(v: np.ndarray, rows: int) -> np.ndarray:
    """A CTA's per-channel sum of its share ``v`` (pixels, cs): thread row
    r0 sums pixels r0, r0 + rows, ... in order; then the rows in order."""
    tot = np.zeros(v.shape[1], np.float32)
    for r0 in range(rows):
        tot = (tot + _seq_sum(v[r0::rows])).astype(np.float32)
    return tot


def _k4_model(x: torch.Tensor, act: str, slope: float = 0.2,
              residual=None, eps: float = 1e-5) -> torch.Tensor:
    """``in_act_cluster_kernel`` on NHWC ``x``."""
    n, h, wd, c = x.shape
    hw = h * wd
    cl = kn.variant(h, wd, c, x.element_size())
    assert cl > 0
    cs = kn.slice_channels(c)
    rows = kn.THREADS // (cs // 8)
    xf = x.float().numpy().reshape(n, hw, c)
    rf = None if residual is None else \
        residual.float().numpy().reshape(n, hw, c)
    y = np.empty_like(xf)
    f32 = np.float32
    for img in range(n):
        for c0 in range(0, c, cs):
            v = xf[img, :, c0:c0 + cs]
            shares = [kn.share(hw, cl, r) for r in range(cl)]
            assert sum(len(s) for s in shares) == hw
            total = np.zeros(cs, f32)
            for s in shares:                       # rank order
                total = (total + _cta_sum(v[s.start:s.stop], rows)).astype(f32)
            mean = (total / f32(hw)).astype(f32)
            d = (v - mean).astype(f32)
            total = np.zeros(cs, f32)
            for s in shares:
                total = (total + _cta_sum((d * d).astype(f32)[s.start:s.stop],
                                          rows)).astype(f32)
            var = (total / f32(hw)).astype(f32)
            rsig = (f32(1) / np.sqrt((var + f32(eps)).astype(f32))).astype(f32)
            o = (d * rsig).astype(f32)
            a = act
            if rf is not None:
                o = (o + rf[img, :, c0:c0 + cs]).astype(f32)
                a = "none" if act == "tanh" else act
            if a == "relu":
                o = np.maximum(o, f32(0))
            elif a == "leaky":
                o = np.where(o >= 0, o, (o * f32(slope)).astype(f32))
            elif a == "tanh":
                o = np.tanh(o).astype(f32)
            y[img, :, c0:c0 + cs] = o
    return torch.from_numpy(y.reshape(n, h, wd, c)).to(x.dtype)


# hw = 1155 is no multiple of the cluster: fp32 takes 8 CTAs of 144 / 145
# pixels, bf16 4 of 288 / 289; (2, 8, 12, 16) takes one CTA
K4_SHAPES = {"33x35x64": (1, 33, 35, 64), "8x12x16": (2, 8, 12, 16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "leaky", "tanh"])
@pytest.mark.parametrize("shape", list(K4_SHAPES))
def test_k4_cluster_matches_plain_and_jax(tpu_interpret, shape, act, res,
                                          dtype):
    # the model against the plain version and JAX's _in_act_kernel /
    # _in_act_res_kernel (interpret mode): fp32 sums in other orders, fp32
    # within 1e-5, bf16 within one ulp
    shp = K4_SHAPES[shape]
    rng = np.random.RandomState(len(act) + 2 * res + shp[1])
    x = (2.0 * rng.randn(*shp) + 0.5).astype(np.float32)
    r = rng.randn(*shp).astype(np.float32) if res else None
    xt = torch.from_numpy(x).to(dtype)
    rt = None if r is None else torch.from_numpy(r).to(dtype)
    assert fused.in_act_fits(xt, rt)
    got = _k4_model(xt, act, residual=rt)
    assert got.dtype == dtype
    _within(got, fused.fused_instance_norm_act_plain(xt, act, residual=rt),
            dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jpk.fused_instance_norm_act(
        jnp.asarray(x).astype(jdt), act=act,
        residual=None if r is None else jnp.asarray(r).astype(jdt))
    _within(got, ref, dtype)


@pytest.mark.parametrize("hw,cl", [(1155, 8), (1155, 4), (4096, 8), (7, 16),
                                   (1024, 2)])
def test_k4_shares_cover_the_slice_once(hw, cl):
    # rank r takes [r·hw/cl, (r+1)·hw/cl): contiguous, disjoint, in rank
    # order, sizes within one pixel of each other
    shares = [kn.share(hw, cl, r) for r in range(cl)]
    assert [p for s in shares for p in s] == list(range(hw))
    sizes = {len(s) for s in shares}
    assert max(sizes) - min(sizes) <= 1 and max(sizes) == -(-hw // cl)


# --------------------------------------------------------------------------- #
# The launches at every path shape
# --------------------------------------------------------------------------- #
# K9: the ResNet-9 head, (B, 256, 256, 64) bf16, at the checked and the
# timed batch: 10 × 16 tiles an image, two persistent blocks an SM
@pytest.mark.parametrize("batch,tiles,blocks", [(8, 1280, 264),
                                                (64, 10240, 264)])
def test_k9_launch_at_the_path_shapes(batch, tiles, blocks):
    assert kh.tiles(batch, 256, 256) == tiles
    assert kh.blocks(batch, 256, 256) == blocks
    assert kh.SMEM_BYTES <= BLOCK_SMEM
    assert kh.BLOCKS_PER_SM * (kh.SMEM_BYTES + RESERVED) <= SM_SMEM


# K4: the ResNet-9 int8 engine's stage norms at 256² (bf16) that
# in_act_fits admits: down_1 and up_0 (64² × 256) and down_2 (32² × 512)
@pytest.mark.parametrize("h,w,c,cl", [(64, 64, 256, 8), (32, 32, 512, 2)])
def test_k4_launch_at_the_path_shapes(h, w, c, cl):
    x = torch.empty(64, h, w, c, dtype=torch.bfloat16, device="meta")
    assert fused.in_act_fits(x)
    assert kn.variant(h, w, c, 2) == cl
    assert kn.slice_channels(c) == 64
    # 64 KB shares: three CTAs an SM
    assert kn.smem_bytes(h, w, c, 2) == 64 * 1024 + kn.STATIC_SMEM
    assert 3 * (kn.smem_bytes(h, w, c, 2) + RESERVED) <= SM_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [8, 16, 24, 40, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("res", [False, True])
def test_k4_every_admitted_shape_takes_a_cluster(dtype, c, res):
    # every image that fused_instance_norm_act sends to K4 fits the
    # cluster's shares (at most 16 CTAs of 128 KB): one read of x
    elem = torch.finfo(dtype).bits // 8
    for hw in (8, 64, 256, 1024, 4096, 16384, 65536):
        h = w = int(hw ** 0.5)
        x = torch.empty(1, h, w, c, dtype=dtype, device="meta")
        if not fused.in_act_fits(x, x if res else None):
            continue
        cl = kn.variant(h, w, c, elem)
        assert cl in (1, 2, 4, 8, 16), (hw, c)
        assert kn.smem_bytes(h, w, c, elem) <= BLOCK_SMEM


@pytest.mark.parametrize("shape,elem,want", [((256, 256, 64), 2, 0),
                                             ((128, 128, 128), 2, 16),
                                             ((128, 128, 128), 4, 0),
                                             ((64, 64, 64), 4, 16)])
def test_k4_variant_beyond_the_rule(shape, elem, want):
    # shapes only a direct call can give: 16 CTAs while a share fits 128
    # KB, else 0 (the three-pass kernel)
    assert kn.variant(*shape, elem) == want


def _constants(path: Path) -> dict:
    src = path.read_text()
    return {k: eval(v) for k, v in re.findall(
        r"constexpr int (\w+) = ([\d\s*+]+);", src)}


def test_mirrors_follow_the_sources():
    # the Python mirrors carry the C sources' constants
    k9, k4 = _constants(CSRC / "head_cout1.cu"), \
        _constants(CSRC / "in_act.cu")
    assert (k9["TC_KCH"], k9["TC_BLOCKS_PER_SM"]) == \
        (kh.CHUNK, kh.BLOCKS_PER_SM)
    assert re.search(r"TC_TH = 16, TC_TW = 26;",
                     (CSRC / "head_cout1.cu").read_text())
    assert (kh.TILE_H, kh.TILE_W) == (16, 26)
    assert kh.SMEM_BYTES == (kh.SPAN_H * kh.SPAN_W * 128
                             + 7 * (kh.ROWS + 4) * 4)
    assert (k4["IN_THREADS"], k4["MAX_CS"], k4["CL_MAX"],
            k4["SHARE_BYTES"], k4["SHARE_BYTES_16"]) == \
        (kn.THREADS, kn.MAX_CS, kn.CL_MAX, kn.SHARE_BYTES,
         kn.SHARE_BYTES_16)


def test_cpu_tensors_take_the_plain_versions():
    # on the CPU the dispatch runs the plain versions and launches nothing
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 8, 8, 16).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.randn(1, 16, 7, 7)).astype(np.float32))
    kh.reset_launches()
    kn.reset_launches()
    assert torch.equal(head_conv_tanh_pallas(x, w, pre_in=True),
                       fused.conv2d_reflect_cout1_plain(x, w, None, "tanh",
                                                        True))
    assert torch.equal(fused.fused_instance_norm_act(x, "relu"),
                       fused.fused_instance_norm_act_plain(x, "relu"))
    assert kh.launches["head_cout1"] == 0 and kn.launches["in_act"] == 0
