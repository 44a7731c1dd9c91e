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

``moe_apply_ep`` / ``_moe_local`` are the reference's expert-parallel
body over ``torch.distributed``: each rank holds E / n of the experts
(``launch/sharding.expert_shard``) and its data shard's rows, routes them
with the replicated router (the same routing on every rank of a model
group), runs its own experts over the pairs routed to them, and the
shares are summed by one ``all_reduce`` over the model group.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as mesh_mod
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

    out = _expert_combine(p, xf, gates, order, counts, kept, k,
                          cfg.num_experts).reshape(B, S, d)
    if cfg.moe_dense_residual:
        out = out + ffn_apply(p["dense"], x)
    return out, aux


def _expert_combine(p: Dict, xf: torch.Tensor, gates: torch.Tensor,
                    order: torch.Tensor, counts, kept, k: int,
                    n_run: int) -> torch.Tensor:
    """Experts 0 .. n_run - 1 of ``p`` over their kept pairs (``order``,
    ``counts``, ``kept`` from ``moe_dispatch``), each pair's output
    weighted by its gate and summed over a token's k slots -> (T, d).  A
    pair not run (dropped, or in a bucket past ``n_run``) adds 0."""
    T, d = xf.shape
    xs = xf[order // k]                           # each pair's token row
    # a dropped pair's row stays zero, as the slab's overflow row
    ys = (torch.zeros_like(xs) if sum(kept[:n_run]) < T * k
          else torch.empty_like(xs))
    start = 0
    for e, (c, n) in enumerate(zip(counts[:n_run], kept[:n_run])):
        if n:
            ys[start:start + n] = swiglu(xs[start:start + n],
                                         p["w_gate"][e], p["w_up"][e],
                                         p["w_down"][e])
        start += c
    y = torch.empty_like(ys).index_copy_(0, order, ys)   # pair order
    return (y.view(T, k, d) * gates.to(xf.dtype)[..., None]).sum(dim=1)


# ---------------------------------------------------------------------------
# Expert-parallel MoE (the reference's shard_map body, over ranks)
# ---------------------------------------------------------------------------

def _moe_local(p: Dict, cfg: ModelConfig, xf: torch.Tensor, first: int,
               drop_free: bool):
    """One rank's share: xf (T_loc, d) its data shard's tokens, ``p`` its
    E_loc experts from ``first`` on.  Every token is routed over all E
    experts with the replicated router; the (token, slot) pairs routed
    to this rank's experts are ranked within their expert in token order
    and kept below the capacity (the reference's, over the local tokens;
    T_loc * k with ``drop_free``), the rest go to a bucket that is never
    run.  Returns (the local experts' contribution (T_loc, d), aux,
    (gates, expert ids))."""
    T = xf.shape[0]
    k = cfg.top_k_experts
    E_loc = p["w_gate"].shape[0]
    gates, experts, aux = moe_route(p, cfg, xf)
    cap = moe_capacity(cfg, T, drop_free)
    local = (experts >= first) & (experts < first + E_loc)
    bucket = torch.where(local, experts - first, E_loc)
    order, counts, kept = moe_dispatch(bucket, E_loc + 1, cap)
    if not moe_stats._paused:
        moe_stats.readbacks += 1
        moe_stats.pairs += sum(counts[:E_loc])
        moe_stats.dropped += sum(counts[:E_loc]) - sum(kept[:E_loc])
    y = _expert_combine(p, xf, gates, order, counts, kept, k, E_loc)
    return y, aux, (gates, experts)


def moe_apply_ep(p: Dict, cfg: ModelConfig, x: torch.Tensor, *, pm,
                 drop_free: bool = False, return_routing: bool = False):
    """Expert-parallel MoE over ``pm`` (``launch.plane_mesh.PlaneMesh``):
    ``p`` this rank's expert shard (``launch.sharding.expert_shard``), x
    (B_loc, S, d) its data shard's rows (``launch.sharding.shard_rows``:
    every row where the data axis does not divide the batch), the same on
    every rank of its model group.  The local experts' shares are
    combined by one ``all_reduce`` (sum) over the model group, then the
    dense residual (arctic) is added, replicated; the aux loss is the mean
    of the data shards' (the reference's ``pmean``).  Returns (out
    (B_loc, S, d), aux[, (gates, expert ids) of the local tokens])."""
    B, S, d = x.shape
    first = pm.model_rank * p["w_gate"].shape[0]
    xf = x.reshape(B * S, d)
    y, aux, routing = _moe_local(p, cfg, xf, first, drop_free)
    mesh_mod.all_reduce_sum(y, pm.model_group)
    if cfg.moe_dense_residual:
        y = y + ffn_apply(p["dense"], xf)
    aux = mesh_mod.all_reduce_sum(aux.reshape(1).clone(),
                                  pm.data_group)[0] / pm.dp_size
    out = (y.reshape(B, S, d), aux)
    return out + (routing,) if return_routing else out
