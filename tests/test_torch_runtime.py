"""The port's exported programs and op profiler (``kernels/custom_ops.py``,
``runtime/aot.py``, ``runtime/profiler.py``), on the CPU.

  * every ``cistar`` custom op equals its kernel's plain version bit for
    bit on CPU tensors (the op takes the kernels' GEMM operands, from which
    its CPU implementation takes the plain layout), and its fake function
    gives the real call's shapes and dtypes;
  * ``torch.export`` → ``save`` → ``load`` → run equals the eager call bit
    for bit: the CycleGAN ``bilinear_content`` int8 engine (the per-rank
    program of ``make_sharded_infer``, weights as arguments; the ResNet
    engines' programs, bf16 and int8, are held so in
    ``tests/test_torch_parallel.py``, inside the sharded wrapper), the
    ResNet bf16 program through ``cyclegan_test --export_engine`` /
    ``--engine_file`` (its int8 one in
    ``tests/test_torch_cyclegan_families.py``), and the pix2pixHD
    ``UNet`` and ``global`` int8 engines (``p2phd_test --data_type 8``'s
    program), and the cout-tiled chain (K7a / K7b);
  * ``format_op_table`` prints the JAX package's text on the same rows;
    ``profile_op_table`` on a CPU function, ``profile_fn``,
    ``cost_analysis``;
  * the test CLIs' export flags end to end on ``--device cpu``.
"""

import os

import numpy as np
import pytest
import torch

from cistar_tpu.runtime.profiler import format_op_table as jax_format
from cistar_tpu_torch.apps import cyclegan_test, p2phd_test
from cistar_tpu_torch.apps.p2phd_options import TestOptions
from cistar_tpu_torch.core import checkpoint as ckpt
from cistar_tpu_torch.engines.cyclegan import (CycleGAN, CycleGANInference,
                                               InferProgram)
from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
from cistar_tpu_torch.kernels.custom_ops import KERNEL_IDS
from cistar_tpu_torch.ops import blocks
from cistar_tpu_torch.ops import fused
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.runtime import aot, profiler

ops = torch.ops.cistar
OPT_TXT = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints",
                       "r2l_MSRB_7", "opt.txt")
EPS = qi.EPS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(*shape, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _block(cls, *args):
    torch.manual_seed(0)
    return cls(*args)


def _cases():
    """op name → (op arguments, the plain version's call)."""
    hx = _x(2, 8, 8, 16)
    q1 = qi.quantize_resblock(_block(blocks.ResidualBlock, 16))
    hq, hs = qi.quantize_act(hx)
    q5 = qi.quantize_atrous_resblock(_block(blocks.ResidualBlockAtrous, 16))
    x6 = _x(2, 16, 16, 16, seed=1)
    q6 = qi.quantize_multi_atrous_stage(_block(blocks.MultiAtrousConv, 16,
                                               32))
    h7 = _x(2, 8, 8, 32, seed=2)
    q7 = qi.quantize_resblock(_block(blocks.ResidualBlock, 32))
    rq, rs = qi.resblock_tiled_a_plain(h7, q7, 16)
    q8 = qi.quantize_msrb(_block(blocks.MSRB, 16))
    x8q, x8s = qi.quantize_act(hx)
    w3, b3 = _x(24, 16, 3, 3, seed=3) * 0.1, _x(24, seed=4)
    r3 = _x(2, 8, 8, 24, seed=5)
    x9 = _x(2, 8, 8, 16, seed=6, dtype=torch.bfloat16)
    w9, b9 = _x(1, 16, 7, 7, seed=7) * 0.1, _x(1, seed=8)
    wt9 = w9[0].permute(1, 2, 0).reshape(49, 16).to(x9.dtype).float()
    x10 = _x(2, 16, 16, 8, seed=9, dtype=torch.bfloat16)
    w10, b10 = _x(16, 8, 7, 7, seed=10) * 0.05, _x(16, seed=11)
    wk10 = w10.permute(0, 2, 3, 1).reshape(16, -1).to(x10.dtype)
    return {
        "resblock_int8_bf16io": (
            (hx, q1["w1k"], q1["w2k"], q1["sb"], EPS, False),
            lambda: qi.resblock_int8_bf16io_plain(hx, q1)),
        "resblock_int8_bf16io-bn": (
            (hx.bfloat16(), q1["w1k"], q1["w2k"], q1["sb"], EPS, True),
            lambda: qi.resblock_int8_bf16io_plain(hx.bfloat16(), q1, True)),
        "resblock_int8": (
            (hq, hs, q1["w1k"], q1["w2k"], q1["sb"], EPS),
            lambda: qi.resblock_int8_plain(hq, hs, q1)),
        "atrous_resblock_int8": (
            (hx, q5["wbk"], q5["wck"], q5["sb"], [2, 4, 6, 8], EPS),
            lambda: qi.atrous_resblock_int8_plain(hx, q5)),
        "multi_atrous_stage_int8": (
            (x6, q6["wbk"], q6["sb"], [1, 2, 3, 4], EPS),
            lambda: qi.multi_atrous_stage_int8_plain(x6[:, ::2, ::2], q6,
                                                     (1, 2, 3, 4))),
        "resblock_int8_tiled_a": (
            (h7, q7["w1k"], q7["sb"], 16, EPS, False),
            lambda: qi.resblock_tiled_a_plain(h7, q7, 16)),
        "resblock_int8_tiled_b": (
            (rq, rs, h7, q7["w2k"], q7["sb"], 16, EPS, True),
            lambda: qi.resblock_tiled_b_plain(rq, rs, h7, q7, 16, True)),
        "msrb_branch_int8": (
            (x8q, x8s, q8["w5ak"], q8["sb1"], 1, 5, 8, True, torch.float32),
            lambda: qi.msrb_branch_plain(x8q, x8s, q8["w5a"], q8["sb1"], 1,
                                         5, 8, True, None)),
        "msrb_branch_int8-bf16": (
            (x8q, x8s, q8["w3ak"], q8["sb1"], 0, 3, 16, False,
             torch.bfloat16),
            lambda: qi.msrb_branch_plain(x8q, x8s, q8["w3a"], q8["sb1"], 0,
                                         3, 16, False, torch.bfloat16)),
        "conv3x3_in_act": (
            (hx, w3.permute(0, 2, 3, 1).reshape(24, -1).contiguous(), b3,
             True, None, True, EPS),
            lambda: fused.fused_conv3x3_in_act_plain(hx, w3, b3, "relu")),
        "conv3x3_in_act-res": (
            (hx, w3.permute(0, 2, 3, 1).reshape(24, -1).contiguous(), None,
             False, r3, False, EPS),
            lambda: fused.fused_conv3x3_in_act_plain(hx, w3, None, "none",
                                                     r3, "zero")),
        "in_act": ((hx, "leaky", 0.2, None, EPS),
                   lambda: fused.fused_instance_norm_act_plain(hx, "leaky")),
        "conv7x7s2_bf16": (
            (x10, wk10, b10),
            lambda: tnn.conv2d(x10, w10, b10, stride=2, padding=3)),
        "head_cout1": (
            (x9, wt9, b9, True, True, EPS),
            lambda: fused.conv2d_reflect_cout1_plain(x9, w9, b9, "tanh",
                                                     True)),
    }


CASES = _cases()


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_custom_op_is_its_plain_version(case):
    args, plain = CASES[case]
    name = case.split("-")[0]
    assert name in KERNEL_IDS
    got, want = _tuple(getattr(ops, name)(*args)), _tuple(plain())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_function_gives_the_real_shapes(case):
    args, _ = CASES[case]
    name = case.split("-")[0]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    got = _tuple(getattr(ops, name)(*meta))
    real = _tuple(getattr(ops, name)(*args))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in real]
    assert all(t.device.type == "meta" for t in got)


# --------------------------------------------------------------------------- #
# export → save → load → run
# --------------------------------------------------------------------------- #
def _roundtrip(tmp_path, module, args):
    with torch.no_grad():
        eager = module(*args)
        path = str(tmp_path / "program.pt2")
        assert aot.save_compiled(module, args, path) == os.path.getsize(path)
        loaded = aot.load_compiled(path)(*args)
    for g, w in zip(_tuple(loaded), _tuple(eager), strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return path


@pytest.mark.parametrize("gen,kind", [("bilinear_content", "int8")])
def test_cyclegan_program_roundtrip(tmp_path, gen, kind):
    eng = CycleGANInference(gen, in_features=8, n_residual_blocks=1,
                            compute_dtype=torch.float32, device="cpu")
    a, b = _x(2, 32, 32, 1, seed=9), _x(2, 32, 32, 1, seed=10)
    extra = eng.program_args(kind)
    _roundtrip(tmp_path, InferProgram(eng, kind == "int8"), extra + (a, b))
    # the program is the engine's own call
    want = eng.infer_step_int8(*extra[2:], (a, b)) if kind == "int8" \
        else eng.infer_step(a, b)
    with torch.no_grad():
        got = InferProgram(eng, kind == "int8")(*extra, a, b)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("net_g", ["UNet", "global"])
def test_p2phd_program_roundtrip(tmp_path, net_g):
    torch.manual_seed(0)
    eng = Pix2PixHDInference(net_g, ngf=4, n_downsample_global=2,
                             n_blocks_global=1, compute_dtype=torch.bfloat16,
                             device="cpu")
    q = eng.quantize_generator()
    label = _x(1, 32, 32, 1, seed=11)
    _roundtrip(tmp_path, eng.program(q), (label,))
    with torch.no_grad():
        got = eng.program(q)(label)
    torch.testing.assert_close(got, eng.infer_step_int8(q, label), rtol=0,
                               atol=0)


class _TiledChain(torch.nn.Module):
    def __init__(self, qblocks, ct):
        super().__init__()
        self.qblocks, self.ct = qblocks, ct

    def forward(self, x):
        return qi.resblock_chain_int8_tiled(x, self.qblocks, self.ct)


def test_k7_chain_roundtrip(tmp_path):
    # the cout-tiled chain (K7a then K7b a block), which global's trunk
    # takes where the whole-image one does not fit (1024 channels)
    qb = [qi.quantize_resblock(_block(blocks.ResidualBlock, 32))
          for _ in range(2)]
    x = _x(2, 8, 8, 32, seed=14, dtype=torch.bfloat16)
    _roundtrip(tmp_path, _TiledChain(qb, 16), (x,))


# --------------------------------------------------------------------------- #
# the op table, profile_fn, cost_analysis
# --------------------------------------------------------------------------- #
ROWS = [{"op": "fusion.12", "count": 30, "total_ms": 12.5, "avg_us": 416.7,
         "pct": 62.5},
        {"op": "a-very-long-kernel-name-" * 4, "count": 3, "total_ms": 5.0,
         "avg_us": 1666.7, "pct": 25.0},
        {"op": "copy", "count": 7, "total_ms": 2.5, "avg_us": 357.1,
         "pct": 12.5}]
TOTALS = {"plane": "/device:TPU:0", "total_ms": 20.0, "runs": 10,
          "per_run_ms": 2.0}


@pytest.mark.parametrize("top", [None, 2, 30])
def test_format_op_table_is_jax_text(top):
    assert profiler.format_op_table(ROWS, TOTALS, top) == \
        jax_format(ROWS, TOTALS, top)
    empty = dict(TOTALS, runs=0)
    assert profiler.format_op_table([], empty, top) == \
        jax_format([], empty, top)


def test_profile_op_table_on_the_cpu():
    eng = CycleGANInference("p2p-content", in_features=8, n_residual_blocks=2,
                            compute_dtype=torch.float32, device="cpu")
    q = eng.quantize_generators()
    a = _x(1, 32, 32, 1, seed=12)
    rows, totals = profiler.profile_op_table(
        lambda x: eng.infer_step_int8(*q, (x, x)), a, iters=2)
    assert set(totals) >= {"plane", "total_ms", "runs", "per_run_ms",
                           "wall_ms"}
    assert totals["plane"] == "/host:CPU" and totals["runs"] == 2
    assert sum(r["pct"] for r in rows) == pytest.approx(100.0)
    assert sum(r["total_ms"] for r in rows) == pytest.approx(
        totals["total_ms"])
    assert [r["total_ms"] for r in rows] == sorted(
        (r["total_ms"] for r in rows), reverse=True)
    # 2 runs of 3 generator calls, 2 K1 blocks each
    k1 = {r["op"]: r["count"] for r in rows}["cistar::resblock_int8_bf16io"]
    assert k1 == 12
    text = profiler.format_op_table(rows, totals, top=8)
    assert text.startswith("per-op device time — plane /host:CPU (2 traced")


def test_profile_fn_cost_analysis_and_trace():
    eng = CycleGANInference("p2p-content", in_features=8, n_residual_blocks=2,
                            compute_dtype=torch.float32, device="cpu")
    q = eng.quantize_generators()
    a = _x(1, 32, 32, 1, seed=13)
    stats = aot.profile_fn(lambda x: eng.infer_step(x, x), a, iters=20,
                           warmup=1)
    assert set(stats) == {"mean_ms", "p50_ms", "p95_ms", "best_ms"}
    assert 0 < stats["best_ms"] <= stats["p50_ms"] <= stats["p95_ms"]
    cost = aot.cost_analysis(lambda x: eng.infer_step_int8(*q, (x, x)), a)
    assert cost["flops"] > 0
    assert cost["uncounted_ops"] == ["cistar::resblock_int8_bf16io"]
    with torch.no_grad():
        plain = aot.cost_analysis(lambda x: eng.infer_step(x, x), a)
    assert plain["uncounted_ops"] == [] and plain["flops"] > cost["flops"]


# --------------------------------------------------------------------------- #
# the test CLIs' export flags
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    import importlib.util
    root = str(tmp_path_factory.mktemp("r2l"))
    tool = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "make_synthetic_r2l.py")
    spec = importlib.util.spec_from_file_location("make_synthetic_r2l", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--out", root, "--n", "4", "--size", "64"])
    return root


def test_cyclegan_test_cli_exports_the_sharded_program(pairs, tmp_path):
    # the compute-dtype program (JAX's bf16 engine; the int8 one is
    # test_torch_cyclegan_families.py's), exported per rank and served
    # through --engine_file: the same images as --shard's own program
    from PIL import Image

    model_dir = str(tmp_path / "run")
    os.makedirs(model_dir)
    ckpt.save_cyclegan_state(model_dir, CycleGAN(
        "p2p-content", image_size=64, device="cpu",
        compute_dtype=torch.float32))
    base = ["--dataroot", pairs, "--model_dir", model_dir, "--size", "64",
            "--dtype", "fp32", "--device", "cpu"]
    pt2 = str(tmp_path / "bf16.pt2")
    assert cyclegan_test.main(base + ["--export_engine", pt2]) == pt2
    outs = []
    for extra in (["--shard"], ["--engine_file", pt2]):
        out = cyclegan_test.main(base + extra)
        outs.append({n: np.asarray(Image.open(os.path.join(out, n)))
                     for n in sorted(os.listdir(out))})
    assert list(outs[0]) == list(outs[1]) == ["00003.png", "panel_00003.png"]
    for n in outs[0]:
        np.testing.assert_array_equal(outs[0][n], outs[1][n])


def test_p2phd_test_cli_exports_and_serves_global(tmp_path, capsys):
    # netG global in int8: a G of seeded weights saved as the
    # CLI's checkpoint, exported, then served from the .pt2; the served
    # gallery equals the eager int8 run's, bit for bit
    from PIL import Image

    root = str(tmp_path / "data")
    rng = np.random.RandomState(0)
    for side in ("radar", "lidar"):
        os.makedirs(os.path.join(root, side))
        for i in range(4):
            Image.fromarray((rng.rand(32, 32) * 255).astype(np.uint8)).save(
                os.path.join(root, side, f"{i:05d}.png"))
    ck = tmp_path / "ck"
    args = ["--load_opt", OPT_TXT, "--name", "g", "--netG", "global",
            "--ngf", "4", "--n_downsample_global", "2", "--n_blocks_global",
            "1", "--r2l_res", "32", "--dataroot", root, "--checkpoints_dir",
            str(ck), "--device", "cpu", "--data_type", "8"]
    opt = TestOptions().parse(args, save=False)
    g = Pix2PixHDInference(
        "global", ngf=4, n_downsample_global=2, n_blocks_global=1,
        input_nc=opt.input_nc, output_nc=opt.output_nc,
        label_nc=opt.label_nc, r2l=opt.r2l, no_instance=opt.no_instance,
        device="cpu")
    ckpt.save_network(str(ck / "g"), "G", "latest", g.jax_params()["G"])
    pt2 = str(tmp_path / "global.pt2")
    assert p2phd_test.main(args + ["--export_onnx", pt2]) == pt2
    capsys.readouterr()
    webs = [p2phd_test.main(args + ["--results_dir", str(tmp_path / res),
                                    *extra])
            for res, extra in (("eager", ()), ("engine", ("--engine", pt2)))]
    out = capsys.readouterr().out
    # at this width the whole-image chain fits: K1 (K7 at the 1024-channel
    # trunk, test_k7_chain_roundtrip)
    assert "cistar::resblock_int8_bf16io" in out
    pngs = [sorted(os.listdir(os.path.join(w, "images"))) for w in webs]
    assert pngs[0] == pngs[1] and len(pngs[0]) > 0
    for name in pngs[0]:
        a, b = (np.asarray(Image.open(os.path.join(w, "images", name)))
                for w in webs)
        np.testing.assert_array_equal(a, b)
