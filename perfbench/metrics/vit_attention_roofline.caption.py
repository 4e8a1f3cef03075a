"""The vit_attention kernels' roofline share in the caption attack's vision tower: the launches' bound over their summed device time, in %."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "vit", readers.is_vit)
