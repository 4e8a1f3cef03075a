"""The program's own spans, for the per-layer readers in `metrics/`.

`robustvlm_tpu_torch.utils.profiling` records a span only while a
`torch.profiler` window is open: in a `--trace 1` run, the harness's traced
stretch. A reader takes the spans that opened and closed inside that
window (`complete`) and divides a phase's device milliseconds by the
number of complete enclosing spans (APGD iterations, training steps). It
returns None where the log holds no such span: a `--trace 0` run, a CPU
run (no device interval), or a program without the recorder.
"""

from __future__ import annotations

from typing import List, Optional


def log() -> List[dict]:
    """The program's span log, or [] where the program has no recorder."""
    from robustvlm_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def phase_ms(entries: List[dict], phase: str, per: str, needs: Optional[str] = None) -> Optional[float]:
    """Device ms of the `phase` spans directly under complete `per` spans,
    summed, over the count of those `per` spans (with `needs`: only those
    with at least one `needs` child); None where there is none to count or
    a span has no device interval."""
    wholes = {s["id"] for s in entries if s["name"] == per and s["complete"]}
    kids = {}
    for s in entries:
        if s["parent"] in wholes:
            kids.setdefault(s["parent"], []).append(s)
    if needs is not None:
        wholes = {w for w in wholes if any(k["name"] == needs for k in kids.get(w, []))}
    if not wholes:
        return None
    parts = [k["device_ms"] for w in wholes for k in kids.get(w, []) if k["name"] == phase]
    if any(p is None for p in parts):
        return None
    return sum(parts) / len(wholes)
