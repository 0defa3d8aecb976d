"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface under ``build/kernels/`` beside the package, the
first time a wrapper needs it (or all at once through :func:`build_all`,
which starts one ``nvcc`` per source in parallel). The library file name
carries a hash of the sources it was built from, so an edited kernel is
rebuilt and a stale one is never loaded. Nothing here runs at import time:
importing the package needs neither ``nvcc`` nor a GPU.

Binding: every C entry takes pointers and the CUDA stream as
``ctypes.c_void_p``, launches on that stream, and returns
``cudaGetLastError()``; :func:`function` binds it once, :func:`check` raises
on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = [*ARCH_FLAGS, "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# Per-source extra flags. The NMS IoU must round exactly as the f32
# expression of the reference, so contraction into FMA is off there. The
# sources that include attention_fwd.cuh take cuTensorMapEncodeTiled from
# the driver through dlopen.
EXTRA_FLAGS = {"nms": ["--fmad=false"], "area_attention": ["-ldl"], "fused_ablock": ["-ldl"],
               "area_attention_bwd": ["-ldl"], "flash_attention": ["-ldl"],
               "fused_c3k2": ["-ldl"]}
SOURCES = ("nms", "area_attention", "fused_ablock", "area_attention_bwd", "flash_attention",
           "fused_c3k2")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # sources and shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(BASE_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    cmd = [_nvcc(), *BASE_FLAGS, *EXTRA_FLAGS.get(name, []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, log


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, log = job
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{text}")
    os.replace(tmp, _lib_path(name))


def build_all() -> None:
    """Compile every kernel source that has no current build, in parallel."""
    jobs = {n: _start(n) for n in SOURCES}
    errors = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as e:  # wait for the others before raising
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for the last build of ``name``."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return _libs[name]


def function(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """C function ``symbol`` of ``csrc/<name>.cu`` with its ctypes signature,
    bound once per library and kept (so a launch pays no binding)."""
    key = (name, symbol)
    if key not in _fns:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[key] = fn
    return _fns[key]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of tensor ``t``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def aligned(t):
    """``t`` contiguous and on a 16-byte boundary, copied where it is not:
    kernels that move 16-byte vectors fault on a view at an odd offset."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
