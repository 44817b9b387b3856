"""ctypes bindings of the port's C++ host runtime
(``csrc/host/whisper_host.cpp``): the DTW path, Levenshtein edit
statistics, the linear resampler and the streaming ring buffer.

The counterpart of the JAX package's ``native_lib.py``. The library is
built at first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``thewhisper_tpu_torch/build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source never loads a stale build. The
compiler writes to a temporary name that is then renamed into place, so
processes that build at once each load a whole library. There is no
fallback: a failed build raises with the compiler's output. The numpy
versions of each function (``align.dtw_path_plain``,
``utils.wer.edit_stats_plain``, ``audio.io.resample_linear_plain``,
``streaming.ring.RingBuffer``) are what tests hold these against.

``DTW_CALLS`` counts the native DTW calls, as a kernel wrapper counts its
launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "host" / "whisper_host.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

DTW_CALLS = 0

_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_IP = ctypes.POINTER(ctypes.c_int)
_P, _N = ctypes.c_void_p, ctypes.c_size_t
# name -> (restype, argtypes) of every C entry point of the source.
_SIGNATURES = {
    "whisper_dtw_path": (ctypes.c_int, [_F64P, ctypes.c_int, ctypes.c_int, _IP, _IP]),
    "whisper_edit_stats": (None, [_I32P, ctypes.c_int, _I32P, ctypes.c_int, _I32P]),
    "whisper_ring_new": (_P, [_N]),
    "whisper_ring_free": (None, [_P]),
    "whisper_ring_write": (_N, [_P, _F32P, _N]),
    "whisper_ring_peek": (_N, [_P, _F32P, _N, _N]),
    "whisper_ring_discard": (_N, [_P, _N]),
    "whisper_ring_size": (_N, [_P]),
    "whisper_ring_clear": (None, [_P]),
    "whisper_resample_linear": (_N, [_F32P, _N, ctypes.c_double, _F32P, _N]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(source: Path = SOURCE, build_dir: Optional[Path] = None) -> Path:
    """Where a build of ``source`` lies in ``build_dir`` (default: the
    module's ``BUILD_DIR`` at the time of the call)."""
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"libwhisper_host-{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Optional[Path] = None) -> Path:
    """The built library's path, compiling ``source`` if no build of it is
    there. Raises ``RuntimeError`` with the compiler's output on failure."""
    target = library_path(source, build_dir)
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host runtime needs a C++ compiler")
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=target.parent, prefix=f".{target.stem}-",
                               suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load(source: Path = SOURCE, build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """Build (if needed) and load a library of ``source``, typed."""
    loaded = ctypes.CDLL(str(build(source, build_dir)))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(loaded, name)
        fn.restype, fn.argtypes = restype, argtypes
    return loaded


def lib() -> ctypes.CDLL:
    """The port's host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


def dtw_path_native(cost: np.ndarray):
    """(text_idx, time_idx) int64 of the DTW path through an (S, T) cost."""
    global DTW_CALLS
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    s, t = cost.shape
    text = np.empty(s + t, dtype=np.int32)
    time_ = np.empty(s + t, dtype=np.int32)
    n = lib().whisper_dtw_path(cost.ctypes.data_as(_F64P), s, t,
                               text.ctypes.data_as(_IP), time_.ctypes.data_as(_IP))
    DTW_CALLS += 1
    return text[:n].astype(np.int64), time_[:n].astype(np.int64)


def edit_stats_native(ref_ids: np.ndarray, hyp_ids: np.ndarray) -> dict:
    """Levenshtein substitutions, deletions, insertions and hits between two
    int32 id sequences."""
    ref_ids = np.ascontiguousarray(ref_ids, dtype=np.int32)
    hyp_ids = np.ascontiguousarray(hyp_ids, dtype=np.int32)
    out = np.zeros(5, dtype=np.int32)
    lib().whisper_edit_stats(ref_ids.ctypes.data_as(_I32P), len(ref_ids),
                             hyp_ids.ctypes.data_as(_I32P), len(hyp_ids),
                             out.ctypes.data_as(_I32P))
    return {"subs": int(out[0]), "dels": int(out[1]), "ins": int(out[2]),
            "hits": int(out[3]), "errors": int(out[4]),
            "ref_len": len(ref_ids), "hyp_len": len(hyp_ids)}


def resample_linear_native(audio: np.ndarray, ratio: float) -> np.ndarray:
    """Linear interpolation at ``k / ratio``, ``round(n * ratio)`` samples."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out_cap = int(len(audio) * ratio + 2)
    out = np.empty(out_cap, dtype=np.float32)
    n = lib().whisper_resample_linear(audio.ctypes.data_as(_F32P), len(audio),
                                      ctypes.c_double(ratio),
                                      out.ctypes.data_as(_F32P), out_cap)
    return out[:n]


class RingBuffer:
    """Growable float32 FIFO over the native ring: ``write``, ``len``,
    ``peek``, ``discard``, ``clear``, clamped as ``streaming/ring.py``'s."""

    def __init__(self, capacity: int = 1 << 18):
        self._lib = lib()
        self._h = self._lib.whisper_ring_new(max(1, int(capacity)))

    def __len__(self) -> int:
        return int(self._lib.whisper_ring_size(self._h))

    def write(self, samples: np.ndarray) -> None:
        x = np.ascontiguousarray(np.asarray(samples, dtype=np.float32).reshape(-1))
        if len(x):
            self._lib.whisper_ring_write(self._h, x.ctypes.data_as(_F32P), len(x))

    def peek(self, n: Optional[int] = None, offset: int = 0) -> np.ndarray:
        """A copy of ``n`` samples (all when None) from ``offset``, clamped
        to what the buffer holds."""
        if offset < 0:
            raise ValueError(f"offset {offset} < 0")
        total = len(self)
        n = total - offset if n is None else min(n, total - offset)
        out = np.empty(max(n, 0), dtype=np.float32)
        if len(out):
            self._lib.whisper_ring_peek(self._h, out.ctypes.data_as(_F32P),
                                        offset, len(out))
        return out

    def discard(self, n: int) -> None:
        """Drop the oldest ``n`` samples (all of them when ``n`` is larger)."""
        self._lib.whisper_ring_discard(self._h, min(max(int(n), 0), len(self)))

    def clear(self) -> None:
        self._lib.whisper_ring_clear(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.whisper_ring_free(h)
