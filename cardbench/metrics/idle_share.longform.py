"""The device's idle share over the traced span, in percent (``harness.readers.idle_share``), in
the cells that report ``rtfx.longform``."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
