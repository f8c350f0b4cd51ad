"""pix2pixHD ``netG=local`` (``LocalEnhancer``) against the benchmark's plain
reference, ``portbench/reference/p2phd_local.py``, on seeded weights at a
small size (ngf 8, 2 global downs, 2 global blocks, 3 local blocks, 64²):
the port's fp32 forward, the int8 engine's CPU path, a comparison that
sees a fine stream left out, and the spans of both engine paths."""

import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference  # noqa: E402
from cistar_tpu_torch.models import fast_infer as fi  # noqa: E402
from cistar_tpu_torch.runtime import spans  # noqa: E402
from portbench import weights  # noqa: E402
from portbench.reference import p2phd_local as L  # noqa: E402

CFG = {"netG": "local", "ngf": 8, "n_downsample_global": 2,
       "n_blocks_global": 2, "n_local_enhancers": 1, "n_blocks_local": 3,
       "input_nc": 1, "output_nc": 1}
OPTS = {k: CFG[k] for k in ("ngf", "n_downsample_global", "n_blocks_global",
                            "n_local_enhancers", "n_blocks_local")}
SIZE = 64
# the int8 trunk families' budget against the fp32 forward, max abs
# (tests/test_torch_local.py, tools/kernel_matrix.py)
BUDGET = 0.35
INFER = ["p2phd.infer", "p2phd.stage_in", "g.encode", "g.trunk", "g.decode",
         "g.enhance"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(dtype=torch.float32, seed=5):
    eng = Pix2PixHDInference("local", compute_dtype=dtype, device="cpu",
                             **OPTS)
    weights.load_into(eng.G, weights.draw(L.generator_spec(CFG), seed, "cpu"))
    return eng


def _x(n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, SIZE, SIZE, 1, generator=g) * 2 - 1


def _reference(seed=5, x=None):
    x = _x() if x is None else x
    return L.generate_nhwc(CFG, weights.draw(L.generator_spec(CFG), seed,
                                             "cpu"), x)


def _rel(y, ref):
    return float((y - ref).norm() / ref.norm())


def test_spec_names_the_port_parameters():
    eng = _engine()
    assert dict(L.generator_spec(CFG)) == {
        k: tuple(v.shape) for k, v in eng.G.named_parameters()}


def test_fp32_forward_matches_the_reference():
    eng = _engine()
    x = _x()
    with torch.no_grad():
        got = eng.G(x)
    ref = _reference(x=x)
    assert got.shape == ref.shape == (2, SIZE, SIZE, 1)
    assert _rel(got, ref) <= 1e-5


def _without_fine_stream(gen, h, pyr):
    # the global G's output (after its ups), averaged over channels and
    # upsampled to the input's size (nearest), through tanh, in the fine
    # stream's place
    for m in gen.global_trunk.up:
        h = m(h)
    m = h.mean(-1, keepdim=True).permute(0, 3, 1, 2)
    return torch.tanh(F.interpolate(m, scale_factor=2)).permute(0, 2, 3, 1)


def test_int8_engine_within_budget_and_a_skipped_fine_stream_is_not(
        monkeypatch):
    eng = _engine()
    x = _x()
    qb = eng.quantize_generator()
    ref = _reference(x=x)
    got = eng.infer_step_int8(qb, x)
    assert float((got - ref).abs().max()) < BUDGET
    monkeypatch.setattr(fi, "local_decode", _without_fine_stream)
    skipped = eng.infer_step_int8(qb, x)
    assert skipped.shape == ref.shape
    assert float((skipped - ref).abs().max()) > BUDGET


@pytest.mark.parametrize("entry", ["infer_step", "infer_step_int8"])
def test_infer_spans(entry):
    eng = _engine(torch.bfloat16)
    call = (eng.infer_step if entry == "infer_step" else
            lambda v: eng.infer_step_int8(eng.quantize_generator(), v))
    x = _x(1)
    with spans.recording() as rec:
        call(x)
    assert [s.name for s in rec.spans] == INFER
    root = rec.spans[0]
    assert root.parent_id is None
    assert all(s.parent_id == root.id and s.root_id == root.id
               for s in rec.spans[1:])
    for a, b in zip(rec.spans[1:], rec.spans[2:]):
        assert a.t1_ns <= b.t0_ns
