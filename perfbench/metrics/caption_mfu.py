"""Model FLOPs of the traced caption-attack iterations (a forward and a pixel gradient each, counted from shapes by counts/) over the traced window's wall time x 989 TFLOP/s, in %."""

from harness import readers


def read(ctx):
    return readers.mfu(ctx)
