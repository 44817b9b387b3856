"""The port's ``utils/flops.py`` and ``utils/profiling.py`` against the JAX
package's: the same FLOP and byte counts, the same ``Stopwatch``; a
``trace`` that holds its ``annotate`` spans, the idle gaps read from a
trace, and ``enable_compilation_cache`` moving both compiled libraries.
All on the CPU (the card's own trace of a K1 launch is in
``tests/test_torch_kernels.py``)."""

import dataclasses
import os

import pytest
import torch

from thewhisper_tpu.config import ARCH_PRESETS as JAX_PRESETS
from thewhisper_tpu.utils import flops as jax_flops
from thewhisper_tpu.utils import profiling as jax_profiling
from thewhisper_tpu_torch import native_lib
from thewhisper_tpu_torch.config import ARCH_PRESETS
from thewhisper_tpu_torch.ops import _build
from thewhisper_tpu_torch.tools import _card
from thewhisper_tpu_torch.utils import flops, profiling

from _torch_tiny import one_cpu_thread  # noqa: F401

# (t_mel, batch, cache_len, t_enc, weight, cache and cross bytes): bench.py's
# 30 s batch-32 shapes with the "S" widths, a 10 s batch-1 window, the bf16
# engine's widths and "S4"'s int4 weights.
SHAPES = [(3000, 32, 84, 1500, 1, 2, 1), (1000, 1, 7, 500, 1, 2, 1),
          (3000, 4, 448, 1500, 2, 2, 2), (3000, 1, 84, 1500, 0.5, 2, 1)]


@pytest.mark.parametrize("name", sorted(ARCH_PRESETS))
def test_counts_equal_jax(name):
    """Each count equals JAX's exactly, on the port's preset against JAX's
    (the two packages' presets hold the same numbers)."""
    arch, ref = ARCH_PRESETS[name], JAX_PRESETS[name]
    assert dataclasses.asdict(arch) == dataclasses.asdict(ref)
    for t_mel, batch, cache_len, t_enc, wb, cb, xb in SHAPES:
        assert flops.encoder_flops(arch, t_mel, batch) == jax_flops.encoder_flops(
            ref, t_mel, batch)
        assert flops.decode_step_flops(arch, cache_len, t_enc, batch) == \
            jax_flops.decode_step_flops(ref, cache_len, t_enc, batch)
        assert flops.decode_step_bytes(arch, cache_len, t_enc, batch, wb, cb, xb) == \
            jax_flops.decode_step_bytes(ref, cache_len, t_enc, batch, wb, cb, xb)
    assert flops.encoder_flops(arch, 3000) == jax_flops.encoder_flops(ref, 3000)
    assert flops.decode_step_flops(arch, 84, 1500) == jax_flops.decode_step_flops(
        ref, 84, 1500)
    assert flops.decode_step_bytes(arch, 84, 1500) == jax_flops.decode_step_bytes(
        ref, 84, 1500)


def test_int4_weights_halve_the_weight_bytes():
    """A fractional ``weight_bytes``: "S4"'s int4 step reads half the
    weight and table bytes of "S"'s int8 one, the same cache bytes."""
    arch = ARCH_PRESETS["large-v3"]
    s = flops.decode_step_bytes(arch, 84, 1500)
    s4 = flops.decode_step_bytes(arch, 84, 1500, weight_bytes=0.5)
    caches = flops.decode_step_bytes(arch, 84, 1500, weight_bytes=0)
    assert s4 - caches == pytest.approx((s - caches) / 2, rel=1e-12)


def test_the_card_peaks_have_one_home():
    """``tools/_card`` re-exports ``utils/flops``'s peaks: the H100 SXM's
    dense rates from NVIDIA's data sheet."""
    for name, value in (("HBM_BYTES_PER_S", 3.35e12), ("BF16_FLOPS", 989e12),
                        ("TF32_FLOPS", 494.7e12), ("F32_FLOPS", 67e12)):
        assert getattr(_card, name) is getattr(flops, name)
        assert getattr(flops, name) == value


def test_trace_holds_its_annotations(tmp_path):
    """``trace`` writes a Chrome-trace file that holds the ``annotate`` span
    (JAX's test checks only that a file exists), yields the profile, and
    ``trace_events`` reads the span back with its op inside it."""
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        with profiling.annotate("tiny-op"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert isinstance(prof, torch.profiler.profile)
    (path,) = log_dir.glob("*.pt.trace.json")
    assert "tiny-op" in path.read_text()
    events = profiling.trace_events(str(log_dir))
    (span,) = [e for e in events if e.get("name") == "tiny-op"]
    assert span["cat"] == "user_annotation"
    (mm,) = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::matmul"]
    assert span["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]
    with pytest.raises(FileNotFoundError):
        profiling.trace_events(str(tmp_path))


def _kernel(ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}


def test_device_idle_is_the_window_less_the_union_of_device_work():
    """Overlapping and nested intervals count once, host events not at all,
    work outside the window is clipped, and the gaps come longest first."""
    events = [_kernel(10, 5), _kernel(12, 8), _kernel(13, 2), _kernel(30, 10, "gpu_memcpy"),
              _kernel(45, 1, "gpu_memset"), _kernel(-5, 8), _kernel(95, 20),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100}]
    busy, gaps = profiling.device_idle(events, 0.0, 100.0)
    assert busy == 3 + 10 + 10 + 1 + 5
    assert gaps == [(46, 95), (20, 30), (3, 10), (40, 45)]
    assert profiling.device_idle([], 0.0, 4.0) == (0.0, [(0.0, 4.0)])


def test_stopwatch_matches_jax(monkeypatch):
    """The same sequence of samples gives the same keys and counts, and
    totals from the same clock."""
    ticks = iter(range(100))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(ticks)))
    summaries = []
    for cls in (profiling.Stopwatch, jax_profiling.Stopwatch):
        watch = cls()
        for name in ("encode", "decode", "decode", "merge", "decode"):
            with watch.measure(name):
                pass
        with pytest.raises(ValueError):
            with watch.measure("failed"):
                raise ValueError
        summaries.append(watch.summary())
    assert summaries[0] == summaries[1]
    assert list(summaries[0]) == ["encode", "decode", "merge", "failed"]
    assert [v["count"] for v in summaries[0].values()] == [1, 3, 1, 1]
    assert summaries[0]["decode"] == {"total_s": 3.0, "count": 3, "mean_ms": 1000.0}


@pytest.fixture
def build_dirs(monkeypatch):
    """Both modules' build directories, restored after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native_lib, "BUILD_DIR", native_lib.BUILD_DIR)
    return _build.BUILD_DIR, native_lib.BUILD_DIR


def test_compilation_cache_moves_both_libraries(tmp_path, monkeypatch, build_dirs):
    """A directory given, else ``WHISPER_COMPILE_CACHE``, else the package's
    ``build/``: both libraries' paths move there (their names stay), and the
    directory is made. No compiler runs."""
    assert build_dirs == (_build.PACKAGE_DIR / "build",) * 2
    names = (_build.library_path().name, native_lib.library_path().name)
    monkeypatch.delenv("WHISPER_COMPILE_CACHE", raising=False)
    assert profiling.enable_compilation_cache() == str(build_dirs[0])
    assert _build.library_path().parent == native_lib.library_path().parent == build_dirs[0]

    given = tmp_path / "given" / "cache"
    assert profiling.enable_compilation_cache(str(given)) == str(given)
    assert given.is_dir()
    assert _build.library_path() == given / names[0]
    assert native_lib.library_path() == given / names[1]

    from_env = tmp_path / "env"
    monkeypatch.setenv("WHISPER_COMPILE_CACHE", str(from_env))
    assert profiling.enable_compilation_cache() == str(from_env)
    assert from_env.is_dir() and os.listdir(from_env) == []
    assert (_build.library_path(), native_lib.library_path()) == (
        from_env / names[0], from_env / names[1])
    assert native_lib.library_path(native_lib.SOURCE, tmp_path) == tmp_path / names[1]


def test_kernel_times_sum_the_device_kernels_by_name():
    events = [_kernel(0, 2), _kernel(5, 3), dict(_kernel(9, 4), name="other"),
              _kernel(20, 7, "gpu_memcpy"),
              {"ph": "X", "cat": "cpu_op", "name": "k", "ts": 0, "dur": 50}]
    assert profiling.kernel_times(events) == {"k": (2, 5.0), "other": (1, 4.0)}
