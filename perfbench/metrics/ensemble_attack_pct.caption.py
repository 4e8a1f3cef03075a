"""The ensemble runner's own attack seconds (attack_s) over its wall seconds, summed over the window's groups, in %: the rest is captioning, scoring and host work."""

from harness import readers


def read(ctx):
    return readers.span_share(ctx, "attack_s", "wall_s")
