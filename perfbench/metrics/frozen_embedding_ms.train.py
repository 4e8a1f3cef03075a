"""Device ms a training step spends embedding the clean images with the frozen original: train.frozen_embedding spans over complete train.step spans in the traced stretch."""

from harness import spans


def read(ctx):
    return spans.phase_ms(spans.log(), "train.frozen_embedding", "train.step")
