"""The ALiBi flash_attention kernels' roofline share in MPT's layers under the caption attack: the launches' bound over their summed device time, in %."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "flash_alibi", readers.is_flash)
