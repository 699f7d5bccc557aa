"""Build and load the CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface; all sources compile in
parallel.  Outputs go to ``svgir_tpu_torch/_build/`` (ignored by git), named
by a digest of the sources, headers and flags, so an edit rebuilds and an
unchanged tree reuses the libraries.  ``ptxas -v`` output (registers,
shared memory, spills) is kept in ``_build/build.log``.

Nothing here runs at import: the first wrapper call builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_OPT_IN_MAX = 232_448   # bytes of shared memory a Hopper block may use

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of svgir_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def _targets() -> dict[str, tuple[Path, Path]]:
    """stem -> (source, library path for the current sources and flags)."""
    common = hashlib.sha256()
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        common.update(hdr.name.encode() + hdr.read_bytes())
    common.update(" ".join(NVCC_FLAGS).encode())
    out = {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        h = common.copy()
        h.update(src.read_bytes())
        out[src.stem] = (src, BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so")
    return out


def build() -> dict[str, Path]:
    """Compile every source whose library is missing (in parallel) and
    return stem -> library path.  Raises with nvcc's output on failure."""
    targets = _targets()
    todo = {stem: t for stem, t in targets.items() if not t[1].exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for stem, (src, lib) in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((stem, tmp, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for stem, tmp, lib, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {stem} (exit {proc.returncode})\n{text}")
            if proc.returncode == 0:
                os.replace(tmp, lib)
            else:
                failed.append(stem)
        (BUILD_DIR / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    return {stem: lib for stem, (_, lib) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(build()[stem]))
        return _libs[stem]


@functools.cache
def entry(stem: str, name: str, argtypes: tuple):
    """The C entry point ``name`` of ``csrc/<stem>.cu``, its argument types
    set once and an int (a CUDA error code) as its result; built and
    loaded on first use, then cached with its configuration."""
    f = getattr(library(stem), name)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (read once)."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc == 1:
        raise RuntimeError(f"{name}: invalid value (error 1): a shape or "
                           "shared-memory size the kernel does not take")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(name: str, t, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: the kernels take nothing else."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(t) -> int:
    """Handle of the current CUDA stream of ``t``'s device (read without
    making a ``torch.cuda.Stream``: this runs once per launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)
