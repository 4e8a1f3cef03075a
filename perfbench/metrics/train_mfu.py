"""Model FLOPs of the traced training steps (the inner attack, the outer forwards and the full backward, counted from shapes by counts/; no replay) over the traced window's wall time x 989 TFLOP/s, in %."""

from harness import readers


def read(ctx):
    return readers.mfu(ctx)
