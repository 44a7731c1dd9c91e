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


def _tree(x: Any, fn, path: tuple = ()):
    """``fn(leaf, path)`` over a pytree, ``path`` the dict keys from the
    root to the leaf."""
    if isinstance(x, dict):
        return {k: _tree(v, fn, path + (k,)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn, path) for v in x]
    return fn(x, path)


# leaves that stay float32 whatever dtype the caller asks for: the MoE
# router, which the reference's ``init_moe_params`` makes float32 in every
# model dtype, the Mamba mixer's dt_bias, A_log and D, float32 in
# ``init_mamba_params``, and RWKV6's decay base, bonus and group norm
# (``init_rwkv_params``) (no other leaf of any model's pytree has these
# keys); and every leaf under RWKV6's float32 layer norms ``ln1`` and
# ``ln2`` (their leaves are named ``w`` and ``b``, so they are keyed by
# their parent)
FLOAT32_LEAVES = ("router", "dt_bias", "A_log", "D", "decay_w0", "bonus_u",
                  "ln_x_w", "ln_x_b")
FLOAT32_TREES = ("ln1", "ln2")


def params_from_numpy(np_params: Dict[str, Any], num_layers: int,
                      dtype: torch.dtype = None, device="cpu") -> Dict:
    """numpy pytree of the reference's parameters -> the port's params.

    Stacked layers (``params["layers"]`` a dict whose leaves lead with
    ``num_layers``) are split into a per-layer list; list-mode layers are
    converted as they are.  ``dtype`` None keeps each array's dtype; a
    ``FLOAT32_LEAVES`` leaf, or a leaf under ``FLOAT32_TREES``, is float32
    whatever ``dtype``."""
    def conv(a, path):
        f32 = any(k in FLOAT32_TREES for k in path) or (
            bool(path) and path[-1] in FLOAT32_LEAVES)
        return _to_tensor(a, torch.float32 if f32 else dtype, device)

    layers = np_params["layers"]
    if isinstance(layers, dict):
        layers = [_tree(layers, lambda a, _k, i=i: np.asarray(a)[i])
                  for i in range(num_layers)]
    out = {k: _tree(v, conv, (k,)) for k, v in np_params.items()
           if k != "layers"}
    out["layers"] = [_tree(lp, conv) for lp in layers]
    return out
