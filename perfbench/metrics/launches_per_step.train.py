"""CUDA kernels in the trace over the training steps traced: the host's dispatch load a step."""

from harness import readers


def read(ctx):
    return readers.launches_per(ctx, "traced_steps")
