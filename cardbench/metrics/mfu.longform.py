"""The whole step's share of the card's peak over the traced span, in percent (``harness.readers.mfu``), in
the cells that report ``rtfx.longform``."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
