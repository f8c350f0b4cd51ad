"""The port stands alone: no module of ``cistar_tpu_torch`` and nothing in
``chip_smoke.py`` (or the data tool it runs) imports JAX, Flax or the JAX
package; entry points run on
CUDA unless told otherwise, and never fall back to the CPU by themselves.
"""

import ast
from pathlib import Path

import pytest
import torch

from cistar_tpu_torch.device import resolve_device
from cistar_tpu_torch.engines.cyclegan import CycleGANInference
from cistar_tpu_torch.engines.p2phd import Pix2PixHD, Pix2PixHDInference
from cistar_tpu_torch.kernels import fused_conv as kf
from cistar_tpu_torch.kernels import head_cout1 as kh
from cistar_tpu_torch.kernels import in_act as kn
from cistar_tpu_torch.kernels import int8_msrb as km
from cistar_tpu_torch.kernels import int8_resblock as kr
from cistar_tpu_torch.kernels import int8_tiled as kt
from cistar_tpu_torch.models.cyclegan import seeded_generator
from cistar_tpu_torch.ops import fused
from cistar_tpu_torch.ops import quant_int8 as qi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "cistar_tpu_torch").rglob("*.py"))
# sklearn: the card's machine has none (apps/encode_features.py carries
# its own k-means)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cistar_tpu", "sklearn"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# chip_smoke.py makes its training frames with tools/make_synthetic_r2l.py
# and its reference checkpoints with tools/reference_twins.py;
# tools/p2p_check_repeat.py runs its phase 36 again and again
@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py",
                                              "tools/make_synthetic_r2l.py",
                                              "tools/p2p_check_repeat.py",
                                              "tools/reference_twins.py"])
def test_no_jax_imports(rel):
    bad = FORBIDDEN.intersection(_imported_roots(ROOT / rel))
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_scan_sees_the_port():
    assert "cistar_tpu_torch/ops/quant_int8.py" in PORT_FILES
    assert {"cistar_tpu_torch/ops/fused.py",
            "cistar_tpu_torch/kernels/fused_conv.py",
            "cistar_tpu_torch/kernels/in_act.py",
            "cistar_tpu_torch/kernels/head_cout1.py"} <= set(PORT_FILES)
    assert "cistar_tpu" not in set(_imported_roots(
        ROOT / "cistar_tpu_torch/ops/quant_int8.py"))


# the pix2pixHD trainer's modules, including the numpy / PIL copies of
# JAX-free modules of the JAX package
@pytest.mark.parametrize("rel", [
    "cistar_tpu_torch/apps/p2phd_options.py",
    "cistar_tpu_torch/apps/p2phd_train.py",
    "cistar_tpu_torch/apps/p2phd_test.py",
    "cistar_tpu_torch/data/aligned.py",
    "cistar_tpu_torch/utils/label_viz.py"])
def test_p2phd_trainer_modules_are_scanned(rel):
    assert rel in PORT_FILES
    assert "cistar_tpu" not in set(_imported_roots(ROOT / rel))


# LPIPS, checkpoint import and the dashboard, including the copies of the
# JAX-free modules core/torch_import.py, core/convert_models.py and
# utils/dashboard.py of the JAX package
@pytest.mark.parametrize("rel", [
    "cistar_tpu_torch/utils/lpips.py",
    "cistar_tpu_torch/utils/fidelity.py",
    "cistar_tpu_torch/core/torch_import.py",
    "cistar_tpu_torch/core/convert_models.py",
    "cistar_tpu_torch/apps/convert_checkpoint.py",
    "cistar_tpu_torch/utils/dashboard.py",
    "cistar_tpu_torch/apps/dashboard.py"])
def test_slice16_modules_are_scanned(rel):
    assert rel in PORT_FILES
    assert "cistar_tpu" not in set(_imported_roots(ROOT / rel))


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        seeded_generator("p2p", 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        CycleGANInference(in_features=8, n_residual_blocks=1)
    for net_g in ("global", "local", "multiscale", "UNet"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Pix2PixHDInference(net_g, ngf=4, n_downsample_global=1,
                               n_blocks_global=1, n_blocks_local=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            Pix2PixHD(net_g, ngf=4, n_downsample_global=1,
                      n_blocks_global=1, n_blocks_local=1, ndf=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    # the CUDA wrappers take CUDA tensors only; the CPU path is the plain
    # version, chosen by the dispatcher in ops/quant_int8.py
    x = torch.zeros(1, 16, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kr.resblock_int8_bf16io(x, {}, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kr.resblock_int8(x.to(torch.int8), torch.ones(1, 1), {}, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kr.conv3x3_reflect_s8(x.to(torch.int8), torch.zeros(128, 9 * 128,
                                                            dtype=torch.int8))


def test_slice3_kernel_wrappers_refuse_cpu_tensors():
    # K7a / K7b / K8 and their grouped int32 convs take CUDA tensors only
    x = torch.zeros(1, 16, 8, 256)
    xq = x.to(torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kt.resblock_int8_tiled_a(x, {}, 128, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kt.resblock_int8_tiled_b(xq, torch.ones(1, 2), x, {}, 128, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kt.conv3x3_reflect_grouped_s8(xq, torch.zeros(256, 9 * 256,
                                                      dtype=torch.int8), 2)
    with pytest.raises(ValueError, match="CUDA"):
        km.msrb_branch_int8(xq, torch.ones(1, 1), torch.zeros(
            128, 9 * 256, dtype=torch.int8), torch.zeros(4, 128), 0, 3, 128,
            True, None)
    with pytest.raises(ValueError, match="CUDA"):
        km.conv_zero_grouped_s8(xq, torch.zeros(128, 25 * 256,
                                                dtype=torch.int8), 5, 2)


def test_bn_kernel_wrappers_refuse_cpu_tensors():
    # the BatchNorm forms of K1 / K7a / K7b take CUDA tensors only
    x = torch.zeros(1, 16, 8, 256)
    with pytest.raises(ValueError, match="CUDA"):
        kr.resblock_int8_bf16io(x, {}, 1e-5, bn=True)
    with pytest.raises(ValueError, match="CUDA"):
        kt.resblock_int8_tiled_a(x, {}, 128, 1e-5, bn=True)
    with pytest.raises(ValueError, match="CUDA"):
        kt.resblock_int8_tiled_b(x.to(torch.int8), torch.ones(1, 2), x, {},
                                 128, 1e-5, bn=True)
    assert all(v == 0 for k, v in (*kr.launches.items(),
                                   *kt.launches.items()) if k.endswith("_bn"))


def test_slice4_kernel_wrappers_refuse_cpu_tensors():
    # K3 / K4 / K9 take CUDA tensors only
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kf.conv3x3_in_act(x, torch.zeros(16, 9 * 16), torch.zeros(16), True,
                          None, True, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kn.in_act(x, "relu", 0.2, None, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kh.head_cout1(x, torch.zeros(49, 16), None, True, False, 1e-5)


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        qi.resblock_int8_bf16io(torch.zeros(1, 2, 2, 1, device="meta"), {})
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused.fused_instance_norm_act(torch.zeros(1, 4, 4, 8, device="meta"))
