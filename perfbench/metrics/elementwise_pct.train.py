"""Device time outside the matrix products and the port's kernels, over all device time of the traced training step, in %."""

from harness import readers


def read(ctx):
    return readers.elementwise_pct(ctx)
