"""K2 against its roofline, in percent (``harness.readers.k2_roofline``), in
the cells that report ``rtfx``."""

from harness.readers import k2_roofline


def read(ctx):
    return k2_roofline(ctx)
