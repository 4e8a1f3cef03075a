"""Device ms an APGD iteration of the caption attack spends in its own update (the l-inf step, the best tracking and the checkpoint's halving): apgd.update spans over complete apgd.iter spans in the traced stretch."""

from harness import spans


def read(ctx):
    return spans.phase_ms(spans.log(), "apgd.update", "apgd.iter")
