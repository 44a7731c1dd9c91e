"""FFN modules of the port: the dense SwiGLU and the Mixture-of-Experts
(the reference's ``models/ffn.py``).

The MoE routes each token to its top-k experts (router logits in float32,
softmax, top-k, gates renormalised) and gives each (token, slot) pair its
rank within its expert in token order, as the reference's
``_dispatch_ranks_onehot`` does; pairs ranked at or past the capacity are
dropped.  The reference computes every expert over a zero-padded
``(E, cap, d)`` slab; here each expert runs only over the pairs routed to
it, grouped by a stable sort on the expert id, which gives the slab's
kept rows (its padding rows are zeros and are never gathered back).
Drop-free, the slab would be ``(E, T * k, d)``: 626 GB at kimi-k2's
14,211-token prompt.  Grouping needs the per-expert counts on the host:
one read-back per MoE call (``moe_stats`` counts them).  The expert
products are ``torch.matmul``, as the reference's are plain einsums.

The reference's expert-parallel body (``moe_apply_ep`` / ``_moe_local``)
is not ported: it belongs with multi-GPU plane sharding.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, swiglu


class MoEStats:
    """MoE calls since the last ``reset``: per-expert count read-backs,
    (token, slot) pairs routed and dropped, and for decode-shaped calls
    (one token per row) the experts each touched (those with a kept
    pair), summed and at most.  Calls made while ``paused`` are not
    counted."""

    def __init__(self):
        self._paused = False
        self.reset()

    @contextlib.contextmanager
    def paused(self, pause: bool = True) -> Iterator[None]:
        """Count no call while entered, if ``pause``: training's remat
        reruns a layer's forward on the backward pass, whose MoE call
        was counted when the forward ran."""
        was, self._paused = self._paused, self._paused or pause
        try:
            yield
        finally:
            self._paused = was

    def reset(self) -> None:
        self.readbacks = 0
        self.pairs = 0
        self.dropped = 0
        self.decode_calls = 0
        self.decode_touched = 0
        self.decode_touched_max = 0

    def snapshot(self) -> Dict[str, int]:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}


moe_stats = MoEStats()


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def init_ffn_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                    device) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": dense_init(gen, (d, f), dtype, device),
            "w_up": dense_init(gen, (d, f), dtype, device),
            "w_down": dense_init(gen, (f, d), dtype, device)}


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                    device) -> Dict:
    """Router (d, E) float32 whatever ``dtype``; experts' w_gate, w_up
    (E, d, f) and w_down (E, f, d) at std 1 / sqrt(E), as the reference's
    ``dense_init`` scales a leading expert axis; arctic's dense SwiGLU
    under ``dense``.  Each expert's slice is drawn on its own, so no
    float32 draw of a whole expert stack is ever held."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(E)

    def experts(shape):
        out = torch.empty((E,) + shape, dtype=dtype, device=device)
        for e in range(E):
            out[e] = dense_init(gen, shape, dtype, device, scale=scale)
        return out
    p = {"router": dense_init(gen, (d, E), torch.float32, device),
         "w_gate": experts((d, f)), "w_up": experts((d, f)),
         "w_down": experts((f, d))}
    if cfg.moe_dense_residual:
        p["dense"] = init_ffn_params(cfg, gen, dtype, device)
    return p


def moe_capacity(cfg: ModelConfig, tokens: int, drop_free: bool) -> int:
    """Pairs an expert keeps: capacity_factor * T * k / E + 1, rounded up
    to a multiple of 4 (at least 4); T * k when ``drop_free``."""
    k = cfg.top_k_experts
    cap = int(cfg.capacity_factor * tokens * k / cfg.num_experts) + 1
    cap = max(4, -(-cap // 4) * 4)
    return max(cap, tokens * k) if drop_free else cap


def moe_route(p: Dict, cfg: ModelConfig, xf: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (T, d) -> (gates (T, k) float32 renormalised, expert ids (T, k),
    the Switch load-balance aux loss)."""
    E, k = cfg.num_experts, cfg.top_k_experts
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    ce = F.one_hot(experts[:, 0], E).float().mean(dim=0)
    aux = E * (probs.mean(dim=0) * ce).sum()
    return gates, experts, aux


def moe_dispatch(experts: torch.Tensor, num_experts: int, cap: int):
    """Group the (token, slot) pairs of ``experts`` (T, k) by expert:
    (order, counts, kept).  ``order`` (T * k,) lists the flat pair indices
    by a stable sort on the expert id, so expert e's pairs lie at
    order[s_e : s_e + counts[e]] (s_e the sum of the counts before it) in
    token order, and the j-th of them has rank j, the reference's
    ``_dispatch_ranks_onehot``; its first ``kept[e] = min(counts[e],
    cap)`` are kept.  ``counts`` is read back to the host."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=num_experts).tolist()
    return order, counts, [min(c, cap) for c in counts]


def moe_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              drop_free: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss).  ``drop_free``: the
    capacity covers every pair, as every serving path runs it (capacity
    must not couple the rows of a batched step); training keeps the
    reference's capacity.  Differentiable: the router's gradient flows
    through the softmax, the renormalised top-k gates and the aux loss;
    a dropped pair's row stays zero, so its token and its gate get no
    gradient from it, as the reference's overflow row gives none."""
    B, S, d = x.shape
    k = cfg.top_k_experts
    T = B * S
    xf = x.reshape(T, d)
    gates, experts, aux = moe_route(p, cfg, xf)
    cap = moe_capacity(cfg, T, drop_free)

    order, counts, kept = moe_dispatch(experts, cfg.num_experts, cap)
    if not moe_stats._paused:
        moe_stats.readbacks += 1
        moe_stats.pairs += T * k
        moe_stats.dropped += T * k - sum(kept)
        if S == 1:
            touched = sum(1 for n in kept if n)
            moe_stats.decode_calls += 1
            moe_stats.decode_touched += touched
            moe_stats.decode_touched_max = max(
                moe_stats.decode_touched_max, touched)

    xs = xf[order // k]                           # each pair's token row
    # a dropped pair's row stays zero, as the slab's overflow row
    ys = (torch.zeros_like(xs) if sum(kept) < T * k
          else torch.empty_like(xs))
    start = 0
    for e, (c, n) in enumerate(zip(counts, kept)):
        if n:
            ys[start:start + n] = swiglu(xs[start:start + n],
                                         p["w_gate"][e], p["w_up"][e],
                                         p["w_down"][e])
        start += c
    y = torch.empty_like(ys).index_copy_(0, order, ys)   # pair order
    out = (y.view(T, k, d) * gates.to(x.dtype)[..., None]).sum(dim=1)
    out = out.reshape(B, S, d)
    if cfg.moe_dense_residual:
        out = out + ffn_apply(p["dense"], x)
    return out, aux
