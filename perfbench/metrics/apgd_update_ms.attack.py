"""Device ms an APGD iteration spends in its own update (the l-inf step, the best tracking and the checkpoint's halving): the program's apgd.update spans over its complete apgd.iter spans in the traced stretch."""

from harness import spans


def read(ctx):
    return spans.phase_ms(spans.log(), "apgd.update", "apgd.iter")
