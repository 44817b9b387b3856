"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process a source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``. A C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. No PyTorch header is compiled, so a cold build takes seconds.

The library lands in ``thewhisper_tpu_torch/build/`` (git-ignored), named by
a hash of the sources and the headers they share (``csrc/*.cuh``), so an
edited source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes of every C entry point in csrc/.
_SIGNATURES = {
    "twt_logmel": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "twt_encoder_attention": [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I, _I, _P],
    "twt_attention_bwd_dkv": [_P] * 8 + [_I] * 6 + [_L] * 12 + [_I, _I, _P],
    "twt_attention_bwd_dq": [_P] * 7 + [_I] * 6 + [_L] * 12 + [_I, _I, _P],
    "twt_mega_step": [_P] * 19 + [_L] + [_P] * 5 + [_I] * 15 + [_P],
    "twt_mega_verify": [_P] * 18 + [_L] + [_P] * 4 + [_I] * 14 + [_P],
    "twt_attention_control": [_P] * 5 + [_I] * 6 + [_P],
    "twt_mlp_chain": [_P] * 11 + [_I] * 6 + [_P],
    "twt_write_row": [_P, _P, _P, _I, _I, _I, _I, _P],
    "twt_write_column": [_P, _P, _P] + [_I] * 6 + [_P],
    "twt_empty_launch": [_I, _I, _P],
    "twt_int4_linear": [_P] * 5 + [_I] * 11 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Compiler output of the build this process made (ptxas register and
# shared-memory report), and its wall time in seconds; None if it loaded a
# library built earlier.
build_log: Optional[str] = None
build_seconds: Optional[float] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    # Headers too: an edited header must not load a library built before.
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtwt_kernels-{digest.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # Build in a scratch directory beside the target and rename: a
    # concurrent build never sees a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name} ({p.returncode}):\n{out}" for src, p, out
                  in zip(_sources(), procs, outs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / target.name
        link = subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(so, target)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(outs)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, compiling it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            loaded = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream

