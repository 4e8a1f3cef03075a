"""Device ms a training step spends in its inner attack (APGD on the pixels): train.inner_attack spans over complete train.step spans in the traced stretch."""

from harness import spans


def read(ctx):
    return spans.phase_ms(spans.log(), "train.inner_attack", "train.step")
