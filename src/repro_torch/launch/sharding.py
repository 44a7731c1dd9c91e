"""The two layouts the port's mesh bodies use, as slicing functions from
the full (e.g. bridged) tensors to one rank's shard.

Counterpart of two rules of the reference's ``launch/sharding.py``:

* expert-parallel MoE weights: the leading expert axis of ``w_gate``,
  ``w_up`` and ``w_down`` over the model axis (``_param_spec_base``'s
  ``P(model, None, None)``); the router and the dense residual
  replicated, as ``ffn.moe_apply_ep``'s in-specs give them;
* block-sharded decode pools and metadata, ``(dp, None, model, None,
  None)`` (``_state_spec_base`` for ``k`` / ``v`` / ``meta``; quoted at
  the reference's ``cp_decode_attention``): batch rows over the data
  axis where it divides them, the block axis over the model axis.

Each rank builds the same full tensors (from one seed, or through
``bridge.py``) and keeps its slice; the slices are copies, so the full
tensor can be freed.  The reference's tensor-parallel column and row
rules, and its training and batch shardings, have no counterpart yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.launch.plane_mesh import PlaneMesh
from repro_torch.models.model import is_pool_cache


def expert_shard(p: Dict, pm: PlaneMesh) -> Dict:
    """An MoE layer's params ({router, w_gate, w_up, w_down[, dense]})
    with this rank's E / n_model experts, the rest replicated.  Raises
    ``ValueError`` when the model axis does not divide the experts."""
    E, n = p["w_gate"].shape[0], pm.model_size
    if E % n:
        raise ValueError(f"{E} experts do not divide over a {n}-way model "
                         f"axis")
    per = E // n
    first = pm.model_rank * per
    out = dict(p)
    for key in ("w_gate", "w_up", "w_down"):
        out[key] = p[key][first:first + per].clone()
    return out


def shard_rows(x: torch.Tensor, pm: PlaneMesh) -> torch.Tensor:
    """This rank's batch rows (axis 0) of ``x``: its data shard where the
    data axis divides them, else every row (a view)."""
    return x[pm.rows(x.shape[0])]


def pool_shard(cache: Dict[str, torch.Tensor], pm: PlaneMesh
               ) -> Dict[str, torch.Tensor]:
    """A layer's pool cache ({k[, v], meta}, each (B, H, NB, ...)) as this
    rank holds it: rows by ``shard_rows``, blocks [r * NB / n, (r + 1) *
    NB / n) of the model axis.  Raises ``ValueError`` when the model axis
    does not divide NB (``PlaneMesh.round_blocks`` sizes a pool that it
    does)."""
    nb, n = cache["k"].shape[2], pm.model_size
    if nb % n:
        raise ValueError(f"{nb} pool blocks do not divide over a {n}-way "
                         f"model axis")
    per = nb // n
    blocks = slice(pm.model_rank * per, (pm.model_rank + 1) * per)
    return {key: shard_rows(arr, pm)[:, :, blocks].clone(
        memory_format=torch.contiguous_format) for key, arr in cache.items()}


def decode_state_shard(state: Dict, pm: PlaneMesh) -> Dict:
    """A list-mode DecodeState as this rank holds it for the
    context-parallel ``decode_step``: every attention layer's pool cache
    by ``pool_shard``; recurrent states, ``cur_len`` and ``extra`` whole
    (the bodies run everything but the pools' attention replicated)."""
    caches = [pool_shard(c, pm) if is_pool_cache(c) else c
              for c in state["caches"]]
    return {"caches": caches, "cur_len": state["cur_len"].clone(),
            "extra": state["extra"]}
