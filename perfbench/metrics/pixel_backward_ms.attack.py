"""Device ms of the pixel-gradient backward (torch.autograd.grad) an APGD iteration: apgd.backward spans over the complete apgd.iter spans that took a gradient in the traced stretch."""

from harness import spans


def read(ctx):
    return spans.phase_ms(spans.log(), "apgd.backward", "apgd.iter", needs="apgd.backward")
