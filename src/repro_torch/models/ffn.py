"""Dense SwiGLU FFN of the port (the reference's ``models/ffn.py``
``ffn_apply``; its MoE is not ported yet)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import swiglu


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
