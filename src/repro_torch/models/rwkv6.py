"""RWKV-6 "Finch" block — attention-free, data-dependent decay
[arXiv:2404.05892].

Counterpart of ``repro/models/rwkv6.py``.  The time-mix carries a per-head
matrix state ``S`` (hd x hd) and a data-dependent per-channel decay ``w``:

    y_t   = (S_t + (u * k_t) v_t^T)^T r_t
    S_t+1 = diag(w_t) S_t + k_t v_t^T

and the channel-mix a squared-ReLU FFN; both mix each token with the one
before it (the token shift).  Decode carries ``S`` and the two shifted
tokens, an O(1) state with no KV cache, so DSA does not apply.  The
recurrence goes through ``ops.wkv6`` (the ``wkv6`` kernel on the GPU, its
plain version on the CPU) on both serving paths: the decode step is the
window of one token.  With grad enabled (training) it goes through
``ops.Wkv6Fn`` instead, in float32, which differentiates it by the
log of the decay.  Dtypes are the reference's: ``decay_w0``, ``bonus_u``,
``ln_x_w`` and ``ln_x_b`` are float32 whatever the model dtype, so the
decay and the recurrence are float32 (r, k and v are the projections in
the model dtype, widened in the kernel), the shift states keep the
activation dtype and ``S`` is float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, dense_init


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_rwkv_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Random weights drawn from ``gen`` in the reference's order and
    scales (``init_rwkv_params``): the mixing coefficients 0.5, the decay
    base -2, the group norm's weight one and bias zero."""
    d = cfg.d_model
    H, hd = _dims(cfg)
    lora = max(32, d // 32)

    def full(n, value, dt=dtype):
        return torch.full((n,), value, dtype=dt, device=device)

    p = {name: full(d, 0.5) for name in ("mu_r", "mu_k", "mu_v", "mu_g",
                                         "mu_w")}
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = dense_init(gen, (d, d), dtype, device)
    p["decay_w0"] = full(d, -2.0, torch.float32)
    p["decay_A"] = dense_init(gen, (d, lora), dtype, device)
    p["decay_B"] = dense_init(gen, (lora, d), dtype, device, scale=0.01)
    p["bonus_u"] = dense_init(gen, (H, hd), torch.float32, device,
                              scale=0.1)
    p["ln_x_w"] = full(d, 1.0, torch.float32)
    p["ln_x_b"] = full(d, 0.0, torch.float32)
    p["cmu_r"], p["cmu_k"] = full(d, 0.5), full(d, 0.5)
    p["cw_r"] = dense_init(gen, (d, d), dtype, device)
    p["cw_k"] = dense_init(gen, (d, cfg.d_ff), dtype, device)
    p["cw_v"] = dense_init(gen, (cfg.d_ff, d), dtype, device)
    return p


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype,
                    device="cpu") -> Dict[str, torch.Tensor]:
    H, hd = _dims(cfg)
    d = cfg.d_model
    return {"shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
            "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
            "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device)}


def _group_norm(x: torch.Tensor, H: int, w: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the last axis (..., d), d = H * hd, in
    float32, cast back to x's dtype."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], H, shape[-1] // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = (xh - mu).square().mean(dim=-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shape) * w + b).to(x.dtype)


def _time_mix_projections(p: Dict, x: torch.Tensor, xx: torch.Tensor):
    """x and the previous token xx (..., d) -> r, k, v, g, w, log w (w
    and log w float32; exp(log w) is w's arithmetic, so the serve's w is
    the reference's exp(-exp(...)) bit for bit)."""
    def mix(mu):
        return x + (xx - x) * mu
    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = F.silu(mix(p["mu_g"]) @ p["w_g"])
    lr = (torch.tanh(mix(p["mu_w"]) @ p["decay_A"]) @ p["decay_B"]).float()
    logw = -torch.exp(p["decay_w0"] + lr)
    return r, k, v, g, torch.exp(logw), logw


def _last_valid(x: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
    """Each row of x (B, S, d) at its last valid position (token_mask (B,
    S) bool, right padding) -> (B, d)."""
    idx = (token_mask.to(torch.int64).sum(dim=1) - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _shifted(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The token shift: each position's previous token, ``prev`` (B, d)
    before the first."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv_time_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Dict,
                  token_mask: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """The time-mix over a full window: x (B, S, d) -> (out (B, S, d), new
    state).  ``token_mask`` (B, S) bool, right padding: masked positions
    get k = 0 and w = 1, so ``S`` passes through them unchanged, and the
    shift state is each row's last valid token: the returned state is an
    unpadded run's.  Masked positions' outputs are garbage (callers mask
    them out).  With grad enabled and an operand requiring it, the
    recurrence is ``ops.Wkv6Fn`` on log w (training); else ``ops.wkv6``
    (the serve)."""
    H, hd = _dims(cfg)
    B, S, d = x.shape
    r, k, v, g, w, logw = _time_mix_projections(
        p, x, _shifted(x, state["shift_t"]))
    kh = k.reshape(B, S, H, hd)
    wh, logwh = w.reshape(B, S, H, hd), logw.reshape(B, S, H, hd)
    if token_mask is not None:
        tm = token_mask[:, :, None, None]
        kh = kh * tm.to(kh.dtype)
        wh, logwh = torch.where(tm, wh, 1.0), torch.where(tm, logwh, 0.0)
    rh, vh = r.reshape(B, S, H, hd), v.reshape(B, S, H, hd)
    operands = (rh, kh, vh, logwh, p["bonus_u"], state["S"])
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        y, S_fin = ops.Wkv6Fn.apply(*operands)
    else:
        y, S_fin = ops.wkv6(rh, kh.contiguous(), vh, wh.contiguous(),
                            p["bonus_u"], state["S"].contiguous())
    y = _group_norm(y.reshape(B, S, d).to(x.dtype), H, p["ln_x_w"],
                    p["ln_x_b"])
    out = (y * g) @ p["w_o"]
    shift = x[:, -1] if token_mask is None else _last_valid(x, token_mask)
    return out, dict(state, shift_t=shift, S=S_fin)


def rwkv_channel_mix(p: Dict, x: torch.Tensor, state: Dict,
                     token_mask: torch.Tensor = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """The channel-mix over a full window: x (B, S, d) -> (out, new state),
    the shift state each row's last valid token under ``token_mask``."""
    out = _channel_mix(p, x, _shifted(x, state["shift_c"]))
    shift = x[:, -1] if token_mask is None else _last_valid(x, token_mask)
    return out, dict(state, shift_c=shift)


def _channel_mix(p: Dict, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    xr = x + (xx - x) * p["cmu_r"]
    xk = x + (xx - x) * p["cmu_k"]
    r = torch.sigmoid(xr @ p["cw_r"])
    k = torch.square(torch.relu(xk @ p["cw_k"]))
    return r * (k @ p["cw_v"])


def rwkv_time_mix_step(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token per row: x (B, d) -> (out (B, d), new state), the
    window of one token."""
    out, state = rwkv_time_mix(p, cfg, x[:, None], state)
    return out[:, 0], state


def rwkv_channel_mix_step(p: Dict, x: torch.Tensor, state: Dict
                          ) -> Tuple[torch.Tensor, Dict]:
    """One token per row: x (B, d) -> (out (B, d), new state)."""
    out, state = rwkv_channel_mix(p, x[:, None], state)
    return out[:, 0], state
