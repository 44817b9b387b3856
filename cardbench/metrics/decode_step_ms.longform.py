"""Device ms a decode step (``harness.readers.decode_step_ms``), in
the cells that report ``rtfx.longform``."""

from harness.readers import decode_step_ms


def read(ctx):
    return decode_step_ms(ctx)
