"""AdamW and its learning-rate schedules on tensors, the counterpart of
the reference package's ``repro/training/optimizer.py``.

State mirrors the parameter tree: ``{"m": ..., "v": ..., "step": ()}``,
the moments float32 whatever the parameters' dtype, the step an int32
scalar on the parameters' device (so the schedule and the bias
correction never read the device back).  Where the reference returns new
arrays, ``adamw_update`` updates the parameters and the moments IN PLACE
under ``torch.no_grad()``, leaf by leaf in the reference's leaf order
(``tree_leaves``), so a step holds no second copy of the model; a leaf
of more than ``UPDATE_SLICE`` elements (an MoE layer's expert stack) is
updated a slice at a time, so that the update's temporaries take a
slice's memory and not the leaf's (the arithmetic is elementwise: the
same bits either way).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

# elements of a leaf that one pass of the update takes (64 MB of float32)
UPDATE_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"     # "cosine" | "linear" | "constant"


# ---------------------------------------------------------------------------
# Trees: nested dicts and lists of tensors, walked in the reference's
# (jax.tree) order: dict keys sorted, lists in order
# ---------------------------------------------------------------------------

def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs; a path holds dict keys and list indices as
    strings, as the reference's checkpoint keys spell them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf, the structure kept (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1.0 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    return cfg.lr * warm * decay


def init_opt_state(params: Any) -> Dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: Dict
                 ) -> Dict[str, torch.Tensor]:
    """One AdamW step, IN PLACE on ``params`` and ``state``; ``grads`` a
    tree like ``params`` (or its leaves as a list, in ``tree_leaves``
    order).  Returns the metrics {"grad_norm", "lr"} as device scalars."""
    step = state["step"]
    flat_g = grads if isinstance(grads, list) else tree_leaves(grads)
    gn = global_norm(flat_g)
    if cfg.grad_clip > 0:
        scale = torch.minimum(torch.ones_like(gn),
                              torch.full_like(gn, cfg.grad_clip)
                              / torch.clamp(gn, min=1e-9))
    else:
        scale = torch.ones_like(gn)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    flat_p = tree_leaves(params)
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: params, grads and moments differ "
                         "in their leaves")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        decay = p.ndim >= 2   # matrices only (norms and biases excluded)
        for ps, gs, ms, vs in _slices(p, g, m, v):
            gf = gs.float() * scale
            ms.mul_(b1).add_(gf, alpha=1 - b1)
            vs.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
            if decay:
                delta.add_(ps.float(), alpha=cfg.weight_decay)
            ps.copy_(ps.float() - lr * delta)
    step.add_(1)
    return {"grad_norm": gn, "lr": lr}


def _slices(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
    """A leaf's (param, grad, m, v) flattened and cut into views of
    UPDATE_SLICE elements each, in order (one for a smaller leaf).  The
    param and the moments are written through these views, so they must
    be contiguous (``init_params`` and ``init_opt_state`` make them so);
    the grad is only read."""
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("adamw_update: the parameters and the moments "
                         "must be contiguous")
    flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
    return [tuple(t[i:i + UPDATE_SLICE] for t in flat)
            for i in range(0, p.numel(), UPDATE_SLICE)]
