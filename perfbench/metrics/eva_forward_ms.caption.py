"""Device ms an APGD iteration of the BLIP-2 caption attack spends in EVA's forward (the patch embedding, blocks and post-LayerNorm): blip2.vision spans inside complete apgd.iter spans, over those iterations."""

from harness import span_tree, spans


def read(ctx):
    return span_tree.nested_ms(spans.log(), "blip2.vision", "apgd.iter")
