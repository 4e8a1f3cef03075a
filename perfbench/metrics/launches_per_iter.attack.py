"""CUDA kernels in the trace over the APGD iterations traced (one model call each): the host's dispatch load an iteration."""

from harness import readers


def read(ctx):
    return readers.launches_per(ctx, "traced_calls")
