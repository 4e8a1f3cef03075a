"""The vit_attention kernels' roofline share in an attack: the launches' bound over their summed device time, in %."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "vit", readers.is_vit)
