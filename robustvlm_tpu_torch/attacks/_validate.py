"""Threat-model input validation shared by the attack entry points.

Counterpart of `robustvlm_tpu/attacks/_validate.py`: a 0-255-scaled input
would silently turn eps=2/255 into a microscopic perturbation and report
near-clean "robust" accuracy.
"""

from __future__ import annotations

import torch


def check_image_range(x: torch.Tensor, *, what: str = "attack input") -> None:
    mx = float(x.max())
    mn = float(x.min())
    if mx > 1.0 + 1e-5 or mn < -1e-5:
        raise ValueError(
            f"{what} must be unnormalized pixels in [0,1] (threat-model "
            f"contract; eps is in the same units) — got range "
            f"[{mn:.4g}, {mx:.4g}]. Divide by 255?"
        )
