"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``cistar_tpu_torch/csrc/<name>.cu`` becomes one shared library with a
plain C interface, built for Hopper (``sm_90a``) at first use into
``cistar_tpu_torch/kernels/_build/`` (listed in ``.gitignore``). The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. :func:`build_all` starts one
``nvcc`` per source, all at once.

Flags: ``-O3``, no ``--use_fast_math`` (it would replace IEEE division and
rounding that the int8 quantizers must match), and ``--fmad=false`` so that
``a*b+c`` rounds twice, as the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
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
