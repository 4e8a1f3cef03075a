"""Device ms a training step spends in the update (the data-parallel all-reduce, if any, and AdamW): train.optimizer spans over complete train.step spans in the traced stretch."""

from harness import spans


def read(ctx):
    return spans.phase_ms(spans.log(), "train.optimizer", "train.step")
