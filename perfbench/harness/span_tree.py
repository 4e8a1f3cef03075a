"""Spans nested below a phase of their own, for the per-layer readers in
`metrics/`: the model's stages (`blip2.vision`, `blip2.lm`) run inside
`apgd.forward`, itself inside `apgd.iter`, where `spans.phase_ms` reads the
direct children alone. The same rules: spans that opened and closed inside
the traced window, None where the log holds none to read.
"""

from __future__ import annotations

from typing import List, Optional


def nested_ms(entries: List[dict], phase: str, per: str) -> Optional[float]:
    """Device ms of the `phase` spans anywhere below complete `per` spans,
    summed, over the count of those `per` spans; None where there is none
    of either, or a counted span has no device interval."""
    by_id = {s["id"]: s for s in entries}
    wholes = {s["id"] for s in entries if s["name"] == per and s["complete"]}
    if not wholes:
        return None

    def under_whole(s) -> bool:
        up = s["parent"]
        while up is not None and up in by_id:
            if up in wholes:
                return True
            up = by_id[up]["parent"]
        return False

    parts = [s["device_ms"] for s in entries if s["name"] == phase and s["complete"] and under_whole(s)]
    if not parts or any(p is None for p in parts):
        return None
    return sum(parts) / len(wholes)
