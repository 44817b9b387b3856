"""Device ms of the featurizer and encoder a window (``harness.readers.encode_ms``), in
the cells that report ``rtfx.longform``."""

from harness.readers import encode_ms


def read(ctx):
    return encode_ms(ctx)
