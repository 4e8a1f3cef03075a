"""The causal flash_attention kernels' roofline share in OPT's layers under the BLIP-2 caption attack (head dim 80): the launches' bound over their summed device time, in %."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "flash_causal", readers.is_flash)
