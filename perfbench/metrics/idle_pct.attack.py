"""The device's idle share of the traced stretch of an attack: the traced window's seconds in which no CUDA operation ran, over its length, in %."""

from harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
