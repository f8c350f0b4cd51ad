"""The port stands alone: no module of ``cistar_tpu_torch`` and nothing in
``chip_smoke.py`` imports JAX, Flax or the JAX package; entry points run on
CUDA unless told otherwise, and never fall back to the CPU by themselves.
"""

import ast
from pathlib import Path

import pytest
import torch

from cistar_tpu_torch.device import resolve_device
from cistar_tpu_torch.engines.cyclegan import CycleGANInference
from cistar_tpu_torch.kernels import int8_resblock as kr
from cistar_tpu_torch.models.cyclegan import seeded_generator
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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cistar_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_no_jax_imports(rel):
    bad = FORBIDDEN.intersection(_imported_roots(ROOT / rel))
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_scan_sees_the_port():
    assert "cistar_tpu_torch/ops/quant_int8.py" in PORT_FILES
    assert "cistar_tpu" not in set(_imported_roots(
        ROOT / "cistar_tpu_torch/ops/quant_int8.py"))


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        seeded_generator("p2p", 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        CycleGANInference(in_features=8, n_residual_blocks=1)
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


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        qi.resblock_int8_bf16io(torch.zeros(1, 2, 2, 1, device="meta"), {})
