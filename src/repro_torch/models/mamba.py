"""Mamba (selective SSM) block — Jamba's recurrent layer [arXiv:2403.19887].

Counterpart of ``repro/models/mamba.py``.  Prefill runs the selective scan
over the whole window and decode carries an O(1) recurrent state (the
conv window and the SSM state); the layer holds no KV cache, so DSA does
not apply to it.  The scan goes through ``ops.selective_scan`` (the
``selective_scan`` kernel on the GPU, its plain version on the CPU) on
both serving paths: the decode step is the scan of one token.  A window
in float32 (training's forward, its eval without a gradient, a float32
prefill on the CPU) or one that needs a gradient goes through
``ops.SelectiveScanFn`` instead (the same plain scan on the CPU): the
scan's float32 training instance forward and ``selective_scan_bwd``
backward.  The causal conv
stays plain PyTorch (4 taps, elementwise).  Dtypes are the reference's:
``dt_bias``, ``A_log`` and ``D`` are float32 whatever the model dtype, so
``dt`` and the scan are float32; the conv window keeps the activation
dtype and the SSM state is float32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, dense_init


def _dims(cfg: ModelConfig):
    di = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def init_mamba_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                      device) -> Dict[str, torch.Tensor]:
    """Random weights drawn from ``gen`` in the reference's order and
    scales (``init_mamba_params``); ``dt_bias`` -4.6 (softplus^-1(0.01)),
    ``A_log`` log(1..ds) per channel and ``D`` ones, all three float32."""
    d = cfg.d_model
    di, dt_rank, ds, dc = _dims(cfg)
    A = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=device).repeat(di, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype, device),
        "conv_w": dense_init(gen, (di, dc), dtype, device,
                             scale=1.0 / math.sqrt(dc)),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, (di, dt_rank + 2 * ds), dtype, device),
        "dt_proj": dense_init(gen, (dt_rank, di), dtype, device),
        "dt_bias": torch.full((di,), -4.6, dtype=torch.float32,
                              device=device),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 left: torch.Tensor = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x (B, S, di); w (di, dc).  ``left``: the
    last dc-1 inputs of the preceding chunk (B, dc-1, di); zeros, the
    default, give a sequence start.  Float32 sums of the taps in order,
    rounded once to x's dtype."""
    B, S, di = x.shape
    dc = w.shape[1]
    xp = (F.pad(x, (0, 0, dc - 1, 0)) if left is None
          else torch.cat([left.to(x.dtype), x], dim=1))
    out = torch.zeros((B, S, di), dtype=torch.float32, device=x.device)
    for j in range(dc):
        out += xp[:, j:j + S] * w[:, j].float()
    return (out + b).to(x.dtype)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device="cpu") -> Dict[str, torch.Tensor]:
    di, _, ds, dc = _dims(cfg)
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                               device=device)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without a threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _project(p: Dict, cfg: ModelConfig, xc: torch.Tensor):
    """(dt float32, B, C) of the conv output; B and C contiguous, in xc's
    dtype."""
    _, dt_rank, ds, _ = _dims(cfg)
    xdb = xc @ p["x_proj"]
    dt = _softplus(xdb[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    return (dt, xdb[..., dt_rank:dt_rank + ds].contiguous(),
            xdb[..., dt_rank + ds:].contiguous())


def mamba_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Dict = None, return_state: bool = False,
                  token_mask: torch.Tensor = None):
    """x (B, S, d) -> (B, S, d) over a full window (prefill).

    ``state``: the recurrent carry, ``state["ssm"]`` seeding the scan and
    ``state["conv"]`` the conv's left context, so a layer continues
    mid-sequence; a zero state gives a sequence start.  ``token_mask`` (B,
    S) bool, right padding: masked positions get dt = 0, so the scan
    carries the state through them unchanged, and the returned conv
    window is gathered from each row's last valid inputs: the returned
    state is an unpadded run's.  Masked positions' outputs are garbage
    (callers mask them out).  Returns out, or (out, {"conv", "ssm"}) with
    ``return_state``."""
    di, _, ds, dc = _dims(cfg)
    B, S, _ = x.shape
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    left = state["conv"] if state is not None else None
    xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], left=left))
    dt, B_ssm, C_ssm = _project(p, cfg, xc)
    if token_mask is not None:
        dt = dt * token_mask[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"])
    h0 = (state["ssm"] if state is not None
          else torch.zeros((B, di, ds), dtype=torch.float32,
                           device=x.device))
    args = (xc, dt, B_ssm, C_ssm, A, p["D"], h0.contiguous())
    # float32 activations (training's precision, with a gradient or not)
    # and any call that needs a gradient take the training scan; the
    # serve's bfloat16 activations take the serve's
    if xc.dtype == torch.float32 or (
            torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        y, h = ops.SelectiveScanFn.apply(*args)
    else:
        y, h = ops.selective_scan(*args)
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if not return_state:
        return out
    # the conv window: the last dc-1 VALID inputs, the carried left
    # context covering rows whose valid span is shorter than dc-1
    full = torch.cat([left.to(x_in.dtype) if left is not None
                      else x_in.new_zeros((B, dc - 1, di)), x_in], dim=1)
    if token_mask is None:
        new_conv = full[:, S:].contiguous()
    else:
        n_valid = token_mask.to(torch.int64).sum(dim=1)
        idx = n_valid[:, None] + torch.arange(dc - 1, device=x.device)
        new_conv = torch.gather(full, 1, idx[..., None].expand(-1, -1, di))
    return out, {"conv": new_conv, "ssm": h}


def mamba_decode_step(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token per row: x (B, d) -> (out (B, d), new state).  The conv
    runs over the carried window and the token; the SSM update is the
    scan of one token (the reference's step promotes exactly as its scan:
    dt is float32)."""
    di = _dims(cfg)[0]
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    window = torch.cat([state["conv"], x_in[:, None, :]], dim=1)  # (B,dc,di)
    xc = ((window.float() * p["conv_w"].float().t()[None]).sum(dim=1)
          + p["conv_b"])
    xc = F.silu(xc.to(x.dtype))                                  # (B, di)
    dt, B_ssm, C_ssm = _project(p, cfg, xc)
    y, h = ops.selective_scan(xc[:, None], dt[:, None], B_ssm[:, None],
                              C_ssm[:, None], -torch.exp(p["A_log"]),
                              p["D"], state["ssm"].contiguous())
    out = (y[:, 0].to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, {"conv": window[:, 1:].contiguous(), "ssm": h}
