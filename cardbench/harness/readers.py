"""Per-layer readings that more than one metric takes, each in its own
cells: ``idle_share.clips`` and ``idle_share.longform`` read the same
quantity in cells that report different end-to-end metrics. A metric's
file under ``metrics/`` names which it reads."""

from harness import yardsticks as Y
from harness.tracing import short

# K2's kernels by name: bytes an element, the peak of their type.
K2_KERNELS = {"encoder_attention_tc_kernel": (2, Y.BF16_FLOPS),
              "encoder_attention_f32_kernel": (4, Y.F32_FLOPS)}


def idle_share(ctx):
    """Share of the traced span in which the device runs no kernel, copy
    or set (the frozen ``device_idle``), in percent."""
    if ctx.span_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.span_s)


def mfu(ctx):
    """The whole step's share of the card's peak over the traced span, in
    percent: the least time the card needs for the counted operations of
    the traced engine calls, divided by the span. Each part is held to the
    peak of its own type: W8A8 linears (the "S" encoder) at the int8
    rate, everything else at the bf16 rate. Counted from shapes only (the
    frozen ``encoder_parts`` and ``decode_step_flops``), over the real
    rows: the encoder per window, and the decoder for every position fed
    to it (the prompt and each generated token but the last) at the cache
    length it attends."""
    if ctx.span_s <= 0 or not ctx.calls:
        return None
    a = ctx.arch
    linear_peak = Y.INT8_OPS if ctx.mode == "int8-all" else Y.BF16_FLOPS
    least = 0.0
    for c in ctx.calls:
        if c.tokens is None:
            return None
        enc = Y.encoder_parts(a, c.mel_frames, c.rows)
        least += enc["linear"] / linear_peak
        least += (enc["attention"] + enc["conv"]) / Y.BF16_FLOPS
        t_enc = c.mel_frames // 2
        f0 = Y.decode_step_flops(a, 0, t_enc)
        df = Y.decode_step_flops(a, 1, t_enc) - f0
        for r in range(c.rows):
            fed = c.prompt_len + int(c.num_generated[r]) - 1
            least += (fed * f0 + df * fed * (fed - 1) / 2) / Y.BF16_FLOPS
    return 100.0 * least / ctx.span_s


def k2_roofline(ctx):
    """K2 (the encoder's attention kernel) against its roofline, in
    percent: the summed least time of its launches (the larger of
    operations over the peak of its type and bytes over the memory rate,
    from its shapes: q, k, v read once, the output written once) over
    their summed device time. A launch's batch x heads is its grid's
    second dimension; its sequence is the traced calls' encoder
    positions."""
    seqs = {c.mel_frames // 2 for c in ctx.calls}
    if len(seqs) != 1:
        return None
    s = seqs.pop()
    dh = ctx.arch.head_dim
    least = busy = 0.0
    for e in ctx.kernels:
        name = short(e["name"])
        if name not in K2_KERNELS:
            continue
        grid = e.get("args", {}).get("grid")
        if not grid:
            return None
        size, peak = K2_KERNELS[name]
        bh = grid[1]
        t, _ = Y.bound(4 * bh * s * dh * size, 4 * bh * s * s * dh, peak)
        least += t
        busy += e["dur"] / 1e6
    return 100.0 * least / busy if busy else None


def decode_step_ms(ctx):
    """Device ms a decode step: the kernel time that CUDA-graph replays of
    the decode programs launched (attributed by the graph launch's
    correlation id), divided by the step calls the traced engine calls
    ran."""
    steps = sum(c.steps for c in ctx.calls)
    kernels = ctx.device_by(ctx.correlations(graph=True))
    if not steps or not kernels:
        return None
    return sum(e["dur"] for e in kernels) / 1e3 / steps


def encode_ms(ctx):
    """Device ms of the featurizer and encoder a window: the kernel time
    launched inside the benchmark's ``cardbench.encode`` spans (each
    encoder the engine queues), attributed by correlation id, divided by
    the windows (real rows) the traced engine calls encoded."""
    kernels = ctx.device_by(ctx.correlations("cardbench.encode", graph=False))
    windows = ctx.windows()
    if not kernels or not windows:
        return None
    return sum(e["dur"] for e in kernels) / 1e3 / windows


def kernels_per_window(ctx):
    """Kernel launches in the traced span, divided by the windows (real
    rows) the traced engine calls encoded and decoded: a count, which
    fusing the W8A8 encoder's launches or the int8 step's dequantization
    cuts."""
    windows = ctx.windows()
    if not windows or not ctx.kernels:
        return None
    return len(ctx.kernels) / windows
