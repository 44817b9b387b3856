"""The metric arithmetic on synthetic inputs: the readers of a trace, and
a stall inside the window moving rtfx."""

import numpy as np
import pytest


def ev(cat, name, ts, dur, corr=None, **args):
    a = dict(args)
    if corr is not None:
        a["correlation"] = corr
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": a}


class Call:
    def __init__(self, rows, mel_frames=3000, steps=10, generated=8):
        self.rows, self.mel_frames, self.steps = rows, mel_frames, steps
        self.tokens = np.zeros((rows, 4 + generated), np.int32)
        self.num_generated = np.full(rows, generated)
        self.prompt_len = 4


def context(events, calls, mode="bf16"):
    from harness.spec import Arch
    from harness.tracing import TraceContext

    arch = Arch(1280, 32, 20, 4, 20, 5120, 128, 51866, 1500, 448)
    return TraceContext(events, arch, mode, {}, calls)


def trace():
    """A 1000 us window: an encode span launching a K2 kernel (corr 1)
    and a copy (corr 2), a graph launch (corr 3) replaying two kernels,
    and 300 us in which the device is idle."""
    return [
        ev("user_annotation", "cardbench.window", 0, 1000),
        ev("user_annotation", "cardbench.encode", 0, 200),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 5, 1),
        ev("cuda_runtime", "cudaMemcpyAsync", 20, 5, 2),
        ev("kernel", "void (anonymous namespace)::encoder_attention_tc_kernel"
           "(CUtensorMap, int)", 100, 200, 1, grid=[12, 640, 1]),
        ev("gpu_memcpy", "Memcpy HtoD", 300, 100, 2),
        ev("cuda_runtime", "cudaGraphLaunch", 400, 5, 3),
        ev("kernel", "gemv", 500, 100, 3),
        ev("kernel", "argmax", 600, 100, 3),
        ev("cpu_op", "aten::item", 700, 250),
    ]


def test_readers_on_a_synthetic_trace():
    from harness import yardsticks as Y
    from harness.spec import metric_reader

    ctx = context(trace(), [Call(32, steps=4)])
    assert ctx.span_s == pytest.approx(1e-3)
    read = lambda n: metric_reader(n)(ctx)
    # busy 100..400 and 500..700: 500 of 1000 us.
    for kind in ("clips", "longform"):
        assert read(f"idle_share.{kind}") == pytest.approx(50.0)
    for kind in ("clips", "longform"):
        assert read(f"decode_step_ms.{kind}") == pytest.approx(0.2 / 4)
        assert read(f"encode_ms.{kind}") == pytest.approx(0.2 / 32)
        assert read(f"kernels_per_window.{kind}") == pytest.approx(3 / 32)
    bh, s, dh = 640, 1500, 64
    least = max(4 * bh * s * dh * 2 / Y.HBM_BYTES_PER_S,
                4 * bh * s * s * dh / Y.BF16_FLOPS)
    assert read("k2_roofline.clips") == pytest.approx(100 * least / 200e-6)


def test_mfu_holds_each_part_to_its_own_peak():
    from harness import yardsticks as Y
    from harness.readers import mfu
    from harness.spec import Arch

    call = Call(2, generated=3)
    a = Arch(1280, 32, 20, 4, 20, 5120, 128, 51866, 1500, 448)
    enc = Y.encoder_parts(a, 3000, 2)
    dec = 2 * sum(Y.decode_step_flops(a, pos, 1500) for pos in range(4 + 3 - 1))
    for mode, lin in (("bf16", Y.BF16_FLOPS), ("int8-all", Y.INT8_OPS)):
        least = (enc["linear"] / lin + (enc["attention"] + enc["conv"]) / Y.BF16_FLOPS
                 + dec / Y.BF16_FLOPS)
        assert mfu(context(trace(), [call], mode)) == pytest.approx(100 * least / 1e-3)
    assert sum(enc.values()) == pytest.approx(Y.encoder_flops(a, 3000, 2))


def test_readers_find_nothing_where_nothing_ran():
    from harness.spec import metric_reader

    ctx = context([ev("user_annotation", "cardbench.window", 0, 1000)], [])
    for name in ("k2_roofline.clips", "decode_step_ms.longform",
                 "encode_ms.clips", "kernels_per_window.longform",
                 "mfu.clips", "mfu.longform"):
        assert metric_reader(name)(ctx) is None, name


def test_breakdown_names_gaps_by_the_host_span():
    from harness.tracing import breakdown

    b = breakdown(context(trace(), []))
    names = dict(b["device_ops"])
    assert names["encoder_attention_tc_kernel"] == pytest.approx(200e-6)
    gaps = b["idle_gaps"]
    assert gaps[0] == ["cardbench.window / aten::item", pytest.approx(300e-6)]
    assert len(b["device_ops"]) <= 10 and len(gaps) <= 10


def test_a_stall_moves_rtfx():
    from harness.drivers import CallRecord, rtfx

    calls = [CallRecord(0, i, i + 1.0, True, 600.0, []) for i in range(10)]
    base = rtfx(calls)
    assert base == pytest.approx(600.0)
    stalled = calls[:5] + [CallRecord(0, 5, 7.0, True, 600.0, [])] + [
        CallRecord(0, i + 1, i + 2.0, True, 600.0, []) for i in range(6, 10)]
    assert rtfx(stalled) == pytest.approx(6000.0 / 11.0)
    # A failed call's audio does not count.
    failed = calls[:9] + [CallRecord(0, 9, 10.0, False, 600.0, [], error="x")]
    assert rtfx(failed) == pytest.approx(5400.0 / 10.0)

