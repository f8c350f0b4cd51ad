"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``cistar_tpu_torch/csrc/<name>.cu`` becomes one shared library with a
plain C interface, built for Hopper (``sm_90a``) at first use into
``cistar_tpu_torch/kernels/_build/`` (listed in ``.gitignore``). The file
name carries a hash of the source, of every ``csrc/*.cuh`` header it
includes, and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded. :func:`build_all` starts one ``nvcc`` per
source, all at once. :func:`bind` declares the C entries' ``ctypes``
signatures; the ``check_*`` helpers are the wrappers' argument checks.

Flags: ``-O3``, no ``--use_fast_math`` (it would replace IEEE division and
rounding that the int8 quantizers must match), and ``--fmad=false`` so that
``a*b+c`` rounds twice, as the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, else ``PATH``, else the toolkit's
    default prefix; raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of cistar_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _headers(path: Path, seen: Optional[set] = None) -> List[Path]:
    """The ``csrc`` headers that ``path`` includes, directly or not, in
    the order first met."""
    seen = set() if seen is None else seen
    out = []
    for m in _INCLUDE.finditer(path.read_bytes()):
        hdr = CSRC / m.group(1).decode()
        if hdr not in seen:
            seen.add(hdr)
            out += [hdr, *_headers(hdr, seen)]
    return out


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in _headers(src):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


_Job = Tuple[subprocess.Popen, str, Path]


def _start(name: str) -> Optional[_Job]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary name, then rename: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: Optional[_Job]) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Build every source that has no current library, one ``nvcc`` per
    source in parallel. Returns the wall time in seconds."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in sources()}
    for n, job in jobs.items():
        _finish(n, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


# --------------------------------------------------------------------------- #
# Helpers of the kernel wrappers
# --------------------------------------------------------------------------- #
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(lib: ctypes.CDLL, sigs: Mapping[str, Tuple[Sequence, type]]
         ) -> ctypes.CDLL:
    """Declare ``argtypes`` / ``restype`` of each entry in ``sigs``; a
    pointer or stream undeclared would be cut to a 32-bit int."""
    for fname, (args, res) in sigs.items():
        fn = getattr(lib, fname)
        fn.argtypes, fn.restype = list(args), res
    return lib


def check_tensor(t: torch.Tensor, what: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` (and ``shape``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def check_same_device(device, *ts: torch.Tensor) -> None:
    if any(t.device != device for t in ts):
        raise ValueError("weights and activations lie on different devices")


def stream() -> int:
    """PyTorch's current CUDA stream, as the C entries take it."""
    return torch.cuda.current_stream().cuda_stream


def raise_on(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def workspace(nbytes: int, device) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, device=device)
