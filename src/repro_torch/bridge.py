"""Parameter bridge from the reference package to the port.

The reference keeps its parameters as a pytree of arrays, with the layers
of a homogeneous model stacked along a leading axis.  A caller converts
that pytree to numpy (``jax.tree.map(np.asarray, params)``) and hands it
here; this module takes numpy only, so the port never imports JAX.  The
result is the port's list-mode parameter dict (``models/model.py``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)      # numpy has no native bfloat16
    t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree(x: Any, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def params_from_numpy(np_params: Dict[str, Any], num_layers: int,
                      dtype: torch.dtype = None, device="cpu") -> Dict:
    """numpy pytree of the reference's parameters -> the port's params.

    Stacked layers (``params["layers"]`` a dict whose leaves lead with
    ``num_layers``) are split into a per-layer list; list-mode layers are
    converted as they are.  ``dtype`` None keeps each array's dtype."""
    def conv(a):
        return _to_tensor(a, dtype, device)

    layers = np_params["layers"]
    if isinstance(layers, dict):
        layers = [_tree(layers, lambda a, i=i: np.asarray(a)[i])
                  for i in range(num_layers)]
    out = {k: _tree(v, conv) for k, v in np_params.items() if k != "layers"}
    out["layers"] = [_tree(lp, conv) for lp in layers]
    return out
