"""Device ms a training step spends in the outer forwards, loss and the weight backward with remat's replay: train.outer spans over complete train.step spans in the traced stretch."""

from harness import spans


def read(ctx):
    return spans.phase_ms(spans.log(), "train.outer", "train.step")
