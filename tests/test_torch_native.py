"""The port's C++ host runtime (``thewhisper_tpu_torch/native_lib.py`` over
``csrc/host/whisper_host.cpp``) against its numpy versions and the JAX
package's host runtime: DTW paths, edit statistics, the ring buffer and
the linear resampler equal, bit for bit, on seeded inputs; its build is
safe to race and fails loudly."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from thewhisper_tpu import align as jax_align
from thewhisper_tpu import native_lib as jax_native
from thewhisper_tpu_torch import align, native_lib
from thewhisper_tpu_torch.audio import io as pio
from thewhisper_tpu_torch.streaming import ring

from _torch_tiny import one_cpu_thread  # noqa: F401

# The modules (each package's ``utils`` exports a function named ``wer``).
wer = importlib.import_module("thewhisper_tpu_torch.utils.wer")
jax_wer = importlib.import_module("thewhisper_tpu.utils.wer")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cost(seed: int) -> np.ndarray:
    """A seeded (S, T) cost: every fourth seed small integers (cells tie,
    so HF's tie cascade decides the path), seeds 1 and 2 one row and one
    column, seed 3 a 9 s window's alignment shape."""
    rng = np.random.default_rng(seed)
    s, t = int(rng.integers(1, 40)), int(rng.integers(1, 160))
    s, t = {1: (1, t), 2: (s, 1), 3: (40, 450)}.get(seed, (s, t))
    if seed % 4 == 0:
        return rng.integers(0, 3, (s, t)).astype(np.float32)
    return rng.standard_normal((s, t)).astype(np.float32)


@pytest.mark.parametrize("seed", range(20))
def test_dtw_path_equals_plain_and_jax(seed):
    cost = _cost(seed)
    before = native_lib.DTW_CALLS
    got = align.dtw_path(cost)
    assert native_lib.DTW_CALLS == before + 1
    for want in (align.dtw_path_plain(cost), jax_align.dtw_path(cost)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64 and np.array_equal(g, w)
    s, t = cost.shape
    assert (got[0][-1], got[1][-1]) == (s - 1, t - 1)


@pytest.mark.parametrize("seed", range(6))
def test_edit_stats_equal_plain_and_jax(seed):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(4 + seed)]
    ref = list(rng.choice(words, int(rng.integers(0, 30))))
    hyp = list(rng.choice(words, int(rng.integers(0, 30)))) if seed else []
    got = wer.edit_stats(ref, hyp)
    assert got == wer.edit_stats_plain(ref, hyp) == jax_wer.edit_stats(ref, hyp)
    assert got["errors"] == got["subs"] + got["dels"] + got["ins"]
    assert got["hits"] + got["subs"] + got["dels"] == len(ref)


@pytest.mark.parametrize("capacity", [1, 7, 1024, 1 << 18])
def test_ring_buffer_equals_plain_and_jax(capacity):
    """Seeded write, peek, discard and clear sequences through wrap-around
    and growth: the same lengths and peeks as ``streaming/ring.py`` and the
    JAX package's native ring."""
    rng = np.random.default_rng(capacity)
    rings = (native_lib.RingBuffer(capacity), ring.RingBuffer(capacity),
             jax_native.RingBuffer(capacity))
    for _ in range(300):
        op = rng.integers(0, 10)
        if op < 4:
            x = rng.standard_normal(int(rng.integers(0, 3000))).astype(np.float32)
            for r in rings:
                r.write(x)
        elif op < 7:
            n = None if op == 4 else int(rng.integers(0, 4000))
            offset = int(rng.integers(0, 4000))
            peeks = [r.peek(n, offset) for r in rings]
            for p in peeks[1:]:
                np.testing.assert_array_equal(peeks[0], p)
        elif op < 9:
            n = int(rng.integers(0, 4000))
            for r in rings:
                r.discard(n)
        else:
            for r in rings:
                r.clear()
        assert len({len(r) for r in rings}) == 1
    final = [r.peek() for r in rings]
    np.testing.assert_array_equal(final[0], final[1])
    np.testing.assert_array_equal(final[0], final[2])
    for r in rings[:2]:
        with pytest.raises(ValueError, match="offset"):
            r.peek(1, -1)


def test_streaming_pipeline_buffers_in_the_native_ring():
    from thewhisper_tpu_torch.streaming.pipeline import StreamingPipeline

    assert StreamingPipeline.__init__.__globals__["RingBuffer"] is native_lib.RingBuffer


@pytest.mark.parametrize("n,ratio", [(16000, 16000 / 44100), (777, 2.0),
                                     (48000, 1 / 3), (5, 3.3), (1, 0.5), (0, 2.0)])
def test_linear_resampler_equals_plain_and_jax(n, ratio):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = native_lib.resample_linear_native(x, ratio)
    assert got.dtype == np.float32 and len(got) == int(n * ratio + 0.5) * (n > 0)
    np.testing.assert_array_equal(got, jax_native.resample_linear_native(x, ratio))
    np.testing.assert_array_equal(got, pio.resample_linear_plain(x, ratio))


def test_resample_without_scipy_takes_the_native_resampler(monkeypatch):
    x = np.random.default_rng(0).standard_normal(4410).astype(np.float32)
    monkeypatch.setitem(sys.modules, "scipy.signal", None)
    np.testing.assert_array_equal(pio.resample(x, 44100, 16000),
                                  native_lib.resample_linear_native(x, 16000 / 44100))


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two interpreters build the same source into one fresh directory at
    once: each compiles to a temporary name and renames it into place, so
    both load a whole library and leave one behind."""
    code = ("import sys; from pathlib import Path; "
            "from thewhisper_tpu_torch import native_lib as n; "
            "lib = n.load(n.SOURCE, Path(sys.argv[1])); "
            "print(lib.whisper_ring_size(lib.whisper_ring_new(8)))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o[0].strip() for o in outs] == ["0", "0"]
    assert sorted(os.listdir(tmp_path)) == [
        native_lib.library_path(native_lib.SOURCE, tmp_path).name]


def test_a_broken_source_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "whisper_host.cpp"
    src.write_text(native_lib.SOURCE.read_text().replace(
        "int whisper_dtw_path(", "int whisper_dtw_path(undeclared_type x, ", 1))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*undeclared_type"):
        native_lib.load(src, tmp_path / "build")
    assert not any((tmp_path / "build").iterdir())
