"""Training loop of the port: the train step and the host loop with
checkpoints, the counterpart of the reference package's
``repro/training/trainer.py``.

``make_train_step`` builds (params, opt_state, batch) -> (params,
opt_state, metrics): the loss and its gradients by autograd through
``models/model.py``'s ``forward_train`` (whose attention runs the
``flash_prefill`` kernel forward and ``flash_prefill_bwd`` backward on
the card, RWKV6's recurrence ``wkv6``'s float32 training instance
forward and ``wkv6_bwd`` backward, and Mamba's scan
``selective_scan``'s float32 training instance forward and
``selective_scan_bwd`` backward; the MoE at the reference's capacity,
its aux loss in the loss), then AdamW in place.  There is no mesh and no sharding (the
reference's ``launch/steps.py`` and its dry-run specs wait with the plane
meshes, ROADMAP.md).

Precision: parameters, gradients and AdamW moments are float32 on either
device.  On the card the products are ``torch.matmul`` in float32, with
TF32 off (``train`` sets it off; it is off by default); only the attention
kernels run in bfloat16, accumulating in float32 (the recurrences'
training kernels take float32).  On the CPU everything
is float32, as the reference's ``train`` is.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.bridge import FLOAT32_LEAVES, FLOAT32_TREES
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, tree_leaves)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 0             # 0 = only final
    ckpt_path: str = ""
    remat: bool = True
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def trainable(params: Any) -> Any:
    """Mark every leaf of ``params`` as requiring grad (in place)."""
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def frontend_inputs(cfg: ModelConfig, batch: int) -> Dict[str, np.ndarray]:
    """The stubbed frontends' outputs that a training batch carries, as
    the reference's launcher makes them (``src/repro/launch/train.py``):
    Whisper's ``frames`` (B, 16, d) and a VLM's ``patch_embeds`` (B,
    num_patches, d), float32 ones x 0.01; none for the other families."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = np.full((batch, 16, cfg.d_model), 0.01, np.float32)
    if cfg.frontend == "vit_patch_stub":
        out["patch_embeds"] = np.full((batch, cfg.num_patches, cfg.d_model),
                                      0.01, np.float32)
    return out


def batch_to(batch: Dict[str, np.ndarray], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """A numpy batch ({"tokens", "labels"} (B, S) int32[, "frames",
    "patch_embeds"], these as float32) on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.float() if t.is_floating_point() else t).to(device)
    return out


def loss_and_grads(params: Any, cfg: ModelConfig, batch: Dict,
                   remat: bool = True
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loss and its gradients, in ``tree_leaves(params)`` order."""
    leaves = tree_leaves(params)
    loss, _ = M.forward_train(params, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: bool = True) -> Callable:
    M.check_trainable(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch, remat)
        om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}
    return train_step


def _cast(tree: Any, dtype: torch.dtype, f32: bool = False) -> Any:
    """``tree`` with every leaf cast to ``dtype``, except the leaves that
    the model keeps float32 in every dtype (``bridge.FLOAT32_LEAVES``, and
    every leaf under ``FLOAT32_TREES``), as the serve holds them."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, f32 or k in FLOAT32_TREES
                         or k in FLOAT32_LEAVES) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast(v, dtype, f32) for v in tree]
    return tree.to(torch.float32 if f32 else dtype)


class _CastLayers(collections.abc.Sequence):
    """A list of layers' parameters seen in ``dtype`` (``_cast``), each
    layer cast when it is read: one layer's copy at a time, not the
    model's."""

    def __init__(self, layers: List, dtype: torch.dtype):
        self.layers, self.dtype = layers, dtype

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i: int):
        return _cast(self.layers[i], self.dtype)


def make_eval_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> the loss, without gradients.  On the card the
    attention kernel takes bfloat16 only, so there the step evaluates the
    weights in bfloat16 (every product in bfloat16, the loss in float32),
    the float32 leaves kept float32 as the serve keeps them (``_cast``:
    RWKV6's decay, bonus and norms, which its serve's ``wkv6`` takes;
    the MoE router; Mamba's dt_bias, A_log and D):
    the decoder's layers are cast one at a time as the forward reaches
    them, so that no bfloat16 copy of the whole model sits beside the
    float32 training state (8.5 GB at minicpm3-4b); on the CPU the
    weights as they are."""
    M.check_trainable(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        if params["embed"].device.type != "cpu":
            params = {k: (_CastLayers(v, torch.bfloat16) if k == "layers"
                          else _cast(v, torch.bfloat16))
                      for k, v in params.items()}
        loss, _ = M.forward_train(params, cfg, batch, remat=False)
        return loss
    return eval_step


def train(cfg: ModelConfig, tc: TrainConfig, data_cfg: DataConfig,
          *, params=None, seed: int = 0, device="cuda",
          verbose: bool = True) -> Tuple[Any, Dict[str, list]]:
    """Single-process training loop.  Weights from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the GPU unless "cpu"); the loss,
    grad norm and lr are read back only at the log points."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = M.init_params(cfg, gen, torch.float32, device=dev)
    trainable(params)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, tc.opt, tc.remat)
    stream = TokenStream(data_cfg)
    hist: Dict[str, list] = {"loss": [], "grad_norm": [], "lr": [],
                             "step_time": []}
    t_last = time.perf_counter()
    extra = frontend_inputs(cfg, data_cfg.global_batch)
    for step in range(tc.steps):
        batch = batch_to({**stream.batch(), **extra}, dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if (step + 1) % tc.log_every == 0 or step == 0:
            loss = float(m["loss"])
            now = time.perf_counter()
            dt = (now - t_last) / (1 if step == 0 else tc.log_every)
            t_last = now
            hist["loss"].append(loss)
            hist["grad_norm"].append(float(m["grad_norm"]))
            hist["lr"].append(float(m["lr"]))
            hist["step_time"].append(dt)
            if verbose:
                print(f"step {step+1:5d} loss {loss:7.4f} "
                      f"gnorm {float(m['grad_norm']):8.3f} "
                      f"lr {float(m['lr']):.2e} {dt*1e3:7.1f} ms/step")
        if tc.ckpt_every and tc.ckpt_path and (step + 1) % tc.ckpt_every == 0:
            save_checkpoint(tc.ckpt_path, {"params": params,
                                           "opt": opt_state}, step + 1)
    if tc.ckpt_path:
        save_checkpoint(tc.ckpt_path, {"params": params, "opt": opt_state},
                        tc.steps)
    return params, hist
