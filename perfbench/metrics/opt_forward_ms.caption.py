"""Device ms an APGD iteration of the BLIP-2 caption attack spends in OPT's forward (the splice, the blocks, the final LayerNorm and the tied head): blip2.lm spans inside complete apgd.iter spans, over those iterations."""

from harness import span_tree, spans


def read(ctx):
    return span_tree.nested_ms(spans.log(), "blip2.lm", "apgd.iter")
