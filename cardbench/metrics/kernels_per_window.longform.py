"""Kernel launches a window (``harness.readers.kernels_per_window``), in
the cells that report ``rtfx.longform``."""

from harness.readers import kernels_per_window


def read(ctx):
    return kernels_per_window(ctx)
