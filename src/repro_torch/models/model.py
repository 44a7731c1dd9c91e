"""Model assembly of the port: the decoder, with GQA or MLA attention
and a dense or Mixture-of-Experts FFN, Jamba's hybrid of Mamba and
attention layers, RWKV6's attention-free layers, the VLM's prefix of
patch embeddings and Whisper's encoder-decoder.

Counterpart of ``repro/models/model.py`` in list mode (the reference's
stacked layers and its scan paths have no counterpart: PyTorch runs the
layers in a loop).  Parameters are a plain dict of tensors in list
mode:

    {"embed": (V, d), "final_norm": (d,), "lm_head": (d, V),
     "layers": [{"attn_norm", "ffn_norm", "attn": {...}, "ffn": {w_gate,
                 w_up, w_down}}, ...]
     [, "encoder": {"layers": [{"attn_norm", "ffn_norm", "attn", "ffn"}],
                    "final_norm"}]}

with ``attn`` {wq, wk, wv, wo[, bq, bk, bv]} (GQA) or {w_dq, q_norm, w_uq,
w_dkv, kv_norm, w_kr, w_uk, w_uv, wo} (MLA), and ``moe`` {router, w_gate,
w_up, w_down[, dense]} in place of ``ffn`` on the layers where
``cfg.is_moe_layer`` holds, and for Whisper ``cross_norm`` and ``cross``
{wq, wk, wv, wo} on every decoder layer beside the encoder under
``"encoder"`` (``bridge.params_from_numpy`` un-stacks the reference's
stacked layers into this form).  A hybrid's Mamba layers (``layer_kind``
"mamba") hold ``mamba`` {in_proj, conv_w, conv_b, x_proj, dt_proj,
dt_bias, A_log, D, out_proj} in place of ``attn``, with the attention
norm before it and the layer's FFN or MoE after it, and carry a
recurrent state {"conv" (B, dc-1, di), "ssm" (B, di, ds) float32} in
place of a pool cache (``is_pool_cache`` tells them apart).  RWKV6's
layers (``layer_kind`` "rwkv") are {"ln1": {w, b}, "ln2": {w, b}, "rwkv":
{...}}, two float32 layer norms before the time-mix and the channel-mix
(``models/rwkv6.py``), with no attention norm, FFN norm or FFN, and carry
{"shift_t" (B, d), "shift_c" (B, d), "S" (B, H, hd, hd) float32}.
DecodeState is ``{"caches": [per-layer pool dict], "cur_len": (B,)
int32, "extra": {}}``, or for Whisper
``"extra": {"enc_kvs": [(k, v) per layer, each (B, S_enc, Hkv, hd)]}``,
the cross keys and values projected once per request; the pools are
updated IN PLACE by the decode stages.  A layer's KV, as
prefill returns it, is ``(k, v)`` each (B, S, Hkv, hd), or for MLA
``(latent (B, S, 1, kv_lora + rope), None)``: the latent is one head with
no separate value.  A VLM request's patch embeddings
(``inputs["patch_embeds"]`` (B, P, d)) lead its token embeddings, at
positions 0..P-1; a Whisper request's frames (``inputs["frames"]`` (B,
S_enc, d), the conv/mel frontend stubbed) run through the bidirectional
encoder.  A config with ``tie_embeddings`` has no ``lm_head`` leaf: the
head is ``h @ embed.T``, as the reference's ``lm_head``.  Configs the
port does not implement raise ``NotImplementedError`` in
``check_supported``.  Every serving path runs the MoE drop-free
(``moe_drop_free``), as the reference's does.  ``decode_step`` and
``prefill_attn_layer_batched`` take a ``plane_mesh``
(``launch/plane_mesh.py``): the context-parallel decode over
block-sharded pools and the sequence-parallel prefill layer, the
reference's fused ``plane_mesh`` bodies, over ``torch.distributed``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import dsa as dsa_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (ModelConfig, dense_init, layer_norm,
                                       rms_norm, sinusoidal_positions)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    plain = cfg.frontend == "none" and not cfg.is_encoder_decoder
    rwkv = (cfg.attention_type == "none" and cfg.arch_type == "ssm"
            and plain)
    family = ((cfg.arch_type in ("dense", "moe", "hybrid") and plain)
              or (cfg.arch_type == "vlm" and cfg.frontend == "vit_patch_stub"
                  and not cfg.is_encoder_decoder)
              or (cfg.is_encoder_decoder
                  and cfg.frontend == "audio_conv_stub"))
    if (not rwkv and (cfg.attention_type not in ("gqa", "mla")
                      or (cfg.attn_layer_period > 1
                          and cfg.arch_type != "hybrid")
                      or not family)):
        raise NotImplementedError(
            f"{cfg.name}: the port serves GQA and MLA decoders with dense "
            f"or MoE FFNs, Jamba's Mamba + attention hybrid, RWKV6, the "
            f"VLM patch prefix and the Whisper encoder-decoder")


def layer_kind(cfg: ModelConfig, i: int) -> str:
    """Mixer of layer i: 'rwkv' for an attention-free config, 'mamba' for
    a hybrid's non-attention layers, 'attn' otherwise."""
    check_supported(cfg)
    if cfg.attention_type == "none":
        return "rwkv"
    if cfg.arch_type == "hybrid" and not cfg.is_attention_layer(i):
        return "mamba"
    return "attn"


def is_pool_cache(c: Any) -> bool:
    """True for an attention layer's paged-pool cache ({k[, v], meta}),
    False for a recurrent state."""
    return isinstance(c, dict) and "k" in c and "meta" in c


def get_layer(params: Dict, i: int) -> Dict:
    return params["layers"][i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Dict:
    """Random weights drawn from ``generator`` (scaled normals as the
    reference's ``init_params``; norms one, biases zero) — not the
    reference's numbers, which come from ``jax.random``.  Runs on the GPU
    unless ``device="cpu"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    d, V = cfg.d_model, cfg.vocab_size
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = generator

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    def f32(value):
        return torch.full((d,), value, dtype=torch.float32, device=dev)

    m = cfg.mla
    layers = []
    for i in range(cfg.num_layers):
        if layer_kind(cfg, i) == "rwkv":
            # the reference's _init_layer: float32 layer norms, no FFN
            layers.append({"ln1": {"w": f32(1.0), "b": f32(0.0)},
                           "ln2": {"w": f32(1.0), "b": f32(0.0)},
                           "rwkv": rwkv_mod.init_rwkv_params(cfg, g, dtype,
                                                             dev)})
            continue
        if layer_kind(cfg, i) == "mamba":
            mixer = {"mamba": mamba_mod.init_mamba_params(cfg, g, dtype,
                                                          dev)}
        elif cfg.attention_type == "mla":
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            a = {"w_dq": dense_init(g, (d, m.q_lora_rank), dtype, dev),
                 "q_norm": ones(m.q_lora_rank),
                 "w_uq": dense_init(g, (m.q_lora_rank, Hq * qk), dtype, dev),
                 "w_dkv": dense_init(g, (d, m.kv_lora_rank), dtype, dev),
                 "kv_norm": ones(m.kv_lora_rank),
                 "w_kr": dense_init(g, (d, m.qk_rope_head_dim), dtype, dev),
                 "w_uk": dense_init(g, (m.kv_lora_rank,
                                        Hq * m.qk_nope_head_dim), dtype, dev),
                 "w_uv": dense_init(g, (m.kv_lora_rank, Hq * m.v_head_dim),
                                    dtype, dev),
                 "wo": dense_init(g, (Hq * m.v_head_dim, d), dtype, dev)}
            mixer = {"attn": a}
        else:
            a = _init_gqa(cfg, g, dtype, dev)
            if cfg.qkv_bias:
                a.update(bq=zeros(Hq * hd), bk=zeros(Hkv * hd),
                         bv=zeros(Hkv * hd))
            mixer = {"attn": a}
        layer = {"attn_norm": ones(d), "ffn_norm": ones(d), **mixer}
        if cfg.is_encoder_decoder:
            # the reference's init_gqa_params(cross=True): no biases
            layer["cross_norm"] = ones(d)
            layer["cross"] = _init_gqa(cfg, g, dtype, dev)
        if cfg.is_moe_layer(i):
            layer["moe"] = ffn_mod.init_moe_params(cfg, g, dtype, dev)
        else:
            layer["ffn"] = ffn_mod.init_ffn_params(cfg, g, dtype, dev)
        layers.append(layer)
    params = {"embed": dense_init(g, (V, d), dtype, dev, scale=0.02),
              "final_norm": ones(d), "layers": layers}
    if not cfg.tie_embeddings:         # tied: the head is embed.T
        params["lm_head"] = dense_init(g, (d, V), dtype, dev, scale=0.02)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [{"attn_norm": ones(d), "ffn_norm": ones(d),
                        "attn": _init_gqa(cfg, g, dtype, dev),
                        "ffn": ffn_mod.init_ffn_params(cfg, g, dtype, dev)}
                       for _ in range(cfg.encoder_layers)],
            "final_norm": ones(d)}
    return params


def _init_gqa(cfg: ModelConfig, g: torch.Generator, dtype, dev) -> Dict:
    """{wq, wk, wv, wo} of a GQA attention, drawn in that order (the
    decoder adds its QKV biases where the config has them; Whisper's
    cross-attention and encoder have none)."""
    d, Hq, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    return {"wq": dense_init(g, (d, Hq * hd), dtype, dev),
            "wk": dense_init(g, (d, Hkv * hd), dtype, dev),
            "wv": dense_init(g, (d, Hkv * hd), dtype, dev),
            "wo": dense_init(g, (Hq * hd, d), dtype, dev)}


# ---------------------------------------------------------------------------
# Layer forward (full sequence): prefill
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, w, x):
    if isinstance(w, dict):          # RWKV's layer norms
        return layer_norm(x, w["w"], w["b"], cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


def layer_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, kind: str = "attn",
                  rec_state: Optional[Dict] = None,
                  token_mask: Optional[torch.Tensor] = None,
                  enc_kv: Optional[Tuple] = None,
                  k_ctx=None, v_ctx=None, q_offset=0,
                  return_kv: bool = False, moe_drop_free: bool = False,
                  return_aux: bool = False):
    """One transformer layer over a full sequence.  Returns (x_out,
    layer_kv): (k, v) each (B, S, Hkv, hd), or MLA's (latent (B, S, 1,
    kv_lora + rope), None), when ``return_kv``, else None; with
    ``return_aux`` a third element, the MoE's load-balance aux loss (None
    for a layer without one), which training adds.  MLA has no
    attention over earlier chunks' context (as in the reference).
    A Mamba or RWKV layer (``kind`` "mamba" or "rwkv") returns (x_out, its
    new recurrent state) instead, continuing from ``rec_state`` (None: a
    sequence start), with ``token_mask`` marking a padded window's real
    tokens (``mamba.mamba_forward``, ``rwkv6.rwkv_time_mix``).
    ``enc_kv``: the layer's cross keys and values (Whisper); without it a
    decoder layer runs no cross-attention, as in the reference.
    ``moe_drop_free``: the serving prefills set it, so that an MoE's
    capacity cannot drop tokens (the reference's convention)."""
    if kind == "rwkv":
        st = (rec_state if rec_state is not None
              else rwkv_mod.init_rwkv_state(cfg, x.shape[0], x.dtype,
                                            x.device))
        h, st = rwkv_mod.rwkv_time_mix(p["rwkv"], cfg,
                                       _norm(cfg, p["ln1"], x), st,
                                       token_mask=token_mask)
        x = x + h
        h, st = rwkv_mod.rwkv_channel_mix(p["rwkv"],
                                          _norm(cfg, p["ln2"], x), st,
                                          token_mask=token_mask)
        return (x + h, st) + ((None,) if return_aux else ())
    h_in = _norm(cfg, p["attn_norm"], x)
    if kind == "mamba":
        h, new_rec = mamba_mod.mamba_forward(p["mamba"], cfg, h_in,
                                             rec_state, return_state=True,
                                             token_mask=token_mask)
        x, aux = _layer_epilogue(p, cfg, x + h, enc_kv, moe_drop_free)
        return (x, new_rec) + ((aux,) if return_aux else ())
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r}")
    if cfg.attention_type == "mla":
        if k_ctx is not None or int(q_offset) != 0:
            raise NotImplementedError(
                "MLA prefill runs whole prompts: the latent cache has no "
                "chunked-context attention path")
        h, latent = attn.mla_self_attention(p["attn"], cfg, h_in, positions,
                                            return_latent=True)
        k, v = latent[:, :, None, :], None
    else:
        h, k, v = attn.gqa_self_attention(p["attn"], cfg, h_in, positions,
                                          k_ctx=k_ctx, v_ctx=v_ctx,
                                          q_offset=q_offset, return_kv=True)
    x, aux = _layer_epilogue(p, cfg, x + h, enc_kv, moe_drop_free)
    return ((x, (k, v) if return_kv else None)
            + ((aux,) if return_aux else ()))


def _layer_epilogue(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: Optional[Tuple], moe_drop_free: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """What follows a layer's self-attention, residuals included: the
    cross-attention over ``enc_kv`` (Whisper; skipped without it), then
    the FFN or MoE.  x (B, S, d) on a full sequence or (B, d) in decode
    (one query row per request; the MoE on (B, 1, d), always drop-free,
    so that capacity does not couple the rows of a batched step).
    Returns (x, the MoE's aux loss, or None for a dense FFN).  One
    implementation for every caller."""
    if enc_kv is not None and "cross" in p:
        cross = (attn.cross_decode_step if x.dim() == 2
                 else attn.cross_attention)
        x = x + cross(p["cross"], cfg, _norm(cfg, p["cross_norm"], x),
                      *enc_kv)
    h_in = _norm(cfg, p["ffn_norm"], x)
    if "moe" not in p:
        return x + ffn_mod.ffn_apply(p["ffn"], h_in), None
    if x.dim() == 2:
        h, aux = ffn_mod.moe_apply(p["moe"], cfg, h_in[:, None, :],
                                   drop_free=True)
        return x + h[:, 0], aux
    h, aux = ffn_mod.moe_apply(p["moe"], cfg, h_in, drop_free=moe_drop_free)
    return x + h, aux


# ---------------------------------------------------------------------------
# Train forward
# ---------------------------------------------------------------------------

def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port trains ``cfg`` (on
    every device): every family of the registry (dense GQA, MLA, MoE, the
    hybrid of Mamba and attention, RWKV6, the VLM's patch prefix and
    Whisper's encoder-decoder), tied embeddings or not, does; a config
    ``check_supported`` refuses does not."""
    check_supported(cfg)


def forward_train(params: Dict, cfg: ModelConfig, batch: Dict,
                  *, remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S), "labels": (B, S)[, "frames" (B, S_enc,
    d) | "patch_embeds" (B, P, d)]} on the params' device.  Returns
    (loss, logits), the reference's ``forward_train`` for the families
    ``check_trainable`` takes: a VLM's patch embeddings lead the tokens
    and the loss and the returned logits cover the text only (the
    reference's ``logits[:, -labels.shape[1]:]``); Whisper's encoder runs
    over the frames and each decoder layer cross-attends to its
    projected keys and values.  Every attention runs through
    ``ops.flash_prefill``, which differentiates it (``FlashPrefillFn``:
    causal self-attention, MLA's (96, 64) heads, the encoder's and the
    cross-attention's non-causal mode); RWKV6's recurrence through
    ``ops.Wkv6Fn`` and Mamba's through ``ops.SelectiveScanFn``, each
    layer from a fresh recurrent state (the reference's
    ``_fresh_rec_state``).  An MoE runs with the reference's capacity
    (``moe_drop_free`` False: pairs past it are dropped) and the loss is
    the reference's ``loss + 0.01 * aux``, aux the MoE layers' summed
    load-balance losses.  ``remat``: each decoder layer under
    ``torch.utils.checkpoint`` (non-reentrant), its forward run again on
    the backward pass, as ``jax.checkpoint`` wraps one in the reference,
    which does not checkpoint the encoder either; ``ffn.moe_stats``
    counts a layer's MoE call once, not its rerun.  The reference's
    ``triangular`` changes no result and has no counterpart."""
    check_trainable(cfg)
    h, positions = embed_inputs(params, cfg, batch)
    enc_kvs = encode_inputs(params, cfg, batch)
    aux_total = None
    for i in range(cfg.num_layers):
        def run(h_, p=get_layer(params, i), enc_kv=index_enc_kvs(enc_kvs, i),
                kind=layer_kind(cfg, i), calls=[]):
            with ffn_mod.moe_stats.paused(bool(calls)):   # remat's rerun
                calls.append(1)
                h2, _, aux = layer_forward(p, cfg, h_, positions, kind=kind,
                                           enc_kv=enc_kv, return_aux=True)
            return h2, aux
        h, aux = (torch.utils.checkpoint.checkpoint(run, h,
                                                    use_reentrant=False)
                  if remat else run(h))
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    labels = batch["labels"]
    if cfg.frontend == "vit_patch_stub":     # the text's positions only
        h = h[:, -labels.shape[1]:]
    logits = lm_head(params, cfg, h)
    loss = cross_entropy(logits, labels)
    if aux_total is not None:
        loss = loss + 0.01 * aux_total
    return loss, logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token negative log-likelihood in float32 over the labels >= 0
    (a label < 0 is masked)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params: Dict, cfg: ModelConfig, inputs: Dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B,S,d), positions (B,S)).  A VLM's patch
    embeddings (B, P, d), cast to the embeddings' dtype, lead the tokens:
    S = P + the prompt, positions 0..S-1 over both."""
    tokens = inputs["tokens"]
    B = tokens.shape[0]
    h = params["embed"][tokens.long()]
    if cfg.frontend == "vit_patch_stub":
        patches = inputs["patch_embeds"].to(h.device, h.dtype)
        h = torch.cat([patches, h], dim=1)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    return h, positions


def lm_head(params: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head: ``lm_head``, or ``embed.T`` when the
    embeddings are tied (training's gradient then reaches ``embed``
    through both of its uses)."""
    h = _norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def whisper_encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor
                   ) -> torch.Tensor:
    """The bidirectional encoder over frames (B, S_enc, d), the stubbed
    conv/mel frontend's output: sinusoidal positions added in the frames'
    dtype, then the model's dtype (the reference keeps float32 frames in
    float32, which its promotion carries through the bf16 weights; the
    port's attention kernel takes bf16), pre-norm layers whose
    self-attention is non-causal (the ``flash_prefill`` kernel's
    non-causal mode on the GPU), a final norm."""
    B, T, d = frames.shape
    enc = params["encoder"]
    h = frames + sinusoidal_positions(T, d, frames.device).to(frames.dtype)
    h = h.to(params["embed"].dtype)
    positions = torch.arange(T, dtype=torch.int32,
                             device=h.device).expand(B, T)
    for p in enc["layers"]:
        h = h + attn.gqa_self_attention(
            p["attn"], cfg, rms_norm(h, p["attn_norm"], cfg.norm_eps),
            positions, causal=False)
        h = h + ffn_mod.ffn_apply(p["ffn"],
                                  rms_norm(h, p["ffn_norm"], cfg.norm_eps))
    return rms_norm(h, enc["final_norm"], cfg.norm_eps)


def project_encoder_kv(params: Dict, cfg: ModelConfig,
                       enc_out: torch.Tensor) -> List[Tuple]:
    """Every decoder layer's cross keys and values of the encoder output:
    [(k, v)] per layer, each (B, S_enc, Hkv, hd)."""
    return [attn.project_enc_kv(p["cross"], cfg, enc_out)
            for p in params["layers"]]


def index_enc_kvs(enc_kvs: Optional[List[Tuple]], i: int
                  ) -> Optional[Tuple]:
    """Layer i's (k, v) cross-attention cache, or None."""
    return None if enc_kvs is None else enc_kvs[i]


def encode_inputs(params: Dict, cfg: ModelConfig, inputs: Dict
                  ) -> Optional[List[Tuple]]:
    """Whisper's per-layer cross keys and values of ``inputs["frames"]``;
    None for a decoder-only config."""
    if not cfg.is_encoder_decoder:
        return None
    frames = inputs["frames"].to(params["embed"].device)
    return project_encoder_kv(params, cfg,
                              whisper_encode(params, cfg, frames))


# ---------------------------------------------------------------------------
# Decode state / plain prefill
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, num_blocks: int,
                      dtype: torch.dtype, device) -> Dict:
    """List-mode decode state with zero pools (zero recurrent states for
    Mamba and RWKV layers)."""
    dev = torch.device(device)
    return {"caches": [attn.init_layer_kv_pool(cfg, batch, num_blocks,
                                               dtype, dev)
                       if layer_kind(cfg, i) == "attn"
                       else _init_rec_state(cfg, layer_kind(cfg, i), batch,
                                            dtype, dev)
                       for i in range(cfg.num_layers)],
            "cur_len": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "extra": {}}


def kv_to_cache(cfg: ModelConfig, kv: Tuple, num_blocks: int,
                pool_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A layer's prefill KV (``layer_forward``'s layer_kv) as its decode
    pool cache: {"k", "v", "meta"}, or {"k", "meta"} for MLA's latent
    (v None); the metadata from k's values."""
    k, v = kv
    kpool, meta = _kv_to_pool(cfg, k, num_blocks, pool_dtype)
    if v is None:
        return {"k": kpool, "meta": meta}
    vpool, _ = _kv_to_pool(cfg, v, num_blocks, pool_dtype)
    return {"k": kpool, "v": vpool, "meta": meta}


def _kv_to_pool(cfg: ModelConfig, k: torch.Tensor, num_blocks: int,
                pool_dtype: torch.dtype):
    """(B, S, Hkv, D) -> pool (B, Hkv, NB, bs, D) zero-padded, in
    ``pool_dtype``, and its block metadata built from ``k``'s values."""
    B, S, Hkv, D = k.shape
    bs = cfg.dsa.block_size
    padded = k.new_zeros((B, num_blocks * bs, Hkv, D))
    padded[:, :S] = k
    pool = padded.reshape(B, num_blocks, bs, Hkv, D).permute(0, 3, 1, 2, 4)
    valid = (torch.arange(num_blocks * bs, device=k.device) < S).reshape(
        num_blocks, bs).expand(B, Hkv, num_blocks, bs)
    meta = dsa_mod.build_block_metadata(pool, cfg.dsa.metadata, valid)
    return pool.to(pool_dtype).contiguous(), meta


def prefill(params: Dict, cfg: ModelConfig, inputs: Dict, num_blocks: int,
            *, cache_dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    """Plain prefill: full forward over the prompt; returns last-token
    logits and a list-mode DecodeState whose pools hold the prompt KV."""
    h, positions = embed_inputs(params, cfg, inputs)
    B, S, _ = h.shape
    enc_kvs = encode_inputs(params, cfg, inputs)
    caches = []
    for i in range(cfg.num_layers):
        kind = layer_kind(cfg, i)
        h, out = layer_forward(get_layer(params, i), cfg, h, positions,
                               kind=kind, enc_kv=index_enc_kvs(enc_kvs, i),
                               return_kv=True)
        caches.append(kv_to_cache(cfg, out, num_blocks, cache_dtype)
                      if kind == "attn" else out)
    logits = lm_head(params, cfg, h[:, -1:, :])[:, 0]
    state = {"caches": caches,
             "cur_len": torch.full((B,), S, dtype=torch.int32,
                                   device=h.device),
             "extra": {"enc_kvs": enc_kvs} if enc_kvs else {}}
    return logits, state


# ---------------------------------------------------------------------------
# Layer-segmented prefill: the prefill plane's stage functions
# ---------------------------------------------------------------------------

def prefill_embed(params: Dict, cfg: ModelConfig, inputs: Dict):
    """Segment 0 of layer-segmented prefill: the embedding (patches
    included), and for Whisper the encoder and every layer's cross keys
    and values.  Returns (h, positions, enc_kvs or None)."""
    h, positions = embed_inputs(params, cfg, inputs)
    return h, positions, encode_inputs(params, cfg, inputs)


def _init_rec_state(cfg: ModelConfig, kind: str, batch: int, dtype,
                    device="cpu") -> Dict:
    """A zero recurrent state of a Mamba or RWKV layer (its conv window or
    token shifts in ``dtype``, the matrix states float32)."""
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg, batch, dtype, device)
    return mamba_mod.init_mamba_state(cfg, batch, dtype, device)


def _init_rec_states(cfg: ModelConfig, batch: int, dtype,
                     device="cpu") -> List:
    """Per-layer recurrent states: a zero state for each Mamba or RWKV
    layer, None for an attention layer."""
    return [None if layer_kind(cfg, i) == "attn"
            else _init_rec_state(cfg, layer_kind(cfg, i), batch, dtype,
                                 device)
            for i in range(cfg.num_layers)]


def _mask_state(new: Dict, old: Dict, step_mask: torch.Tensor) -> Dict:
    """Per leaf: ``old`` wherever ``step_mask`` (B,) is False (row axis
    0)."""
    return {key: torch.where(
        step_mask.reshape((-1,) + (1,) * (v.dim() - 1)), v, old[key])
        for key, v in new.items()}


def prefill_layer(params: Dict, cfg: ModelConfig, layer_idx: int,
                  h: torch.Tensor, positions: torch.Tensor, *,
                  rec_state=None, enc_kv=None, moe_drop_free: bool = False):
    """ONE layer of prefill over the whole prompt (the legacy
    layer-segmented executor).  The caller saves the returned layer KV to
    DRAM and evicts it before layer l+1.  Returns (h, (k, v), rec_state)
    for an attention layer, (h, None, new_rec) for a Mamba or RWKV
    layer."""
    kind = layer_kind(cfg, layer_idx)
    h, out = layer_forward(get_layer(params, layer_idx), cfg, h, positions,
                           kind=kind, rec_state=rec_state, enc_kv=enc_kv,
                           return_kv=True, moe_drop_free=moe_drop_free)
    if kind == "attn":
        return h, out, rec_state
    return h, None, out


def prefill_finalize(params: Dict, cfg: ModelConfig, h: torch.Tensor
                     ) -> torch.Tensor:
    """Last segment: final norm + head on the last position -> (B, V)."""
    return lm_head(params, cfg, h[:, -1:, :])[:, 0]


def prefill_attn_layer_batched(p: Dict, cfg: ModelConfig, h: torch.Tensor,
                               positions: torch.Tensor,
                               token_mask: torch.Tensor,
                               step_mask: torch.Tensor, *,
                               k_ctx=None, v_ctx=None, q_offset=0,
                               enc_kv=None, plane_mesh=None):
    """One attention layer over a padded batch of same-layer segments.

    h (B, T, d): the rows' residual stream over the segment's token window;
    positions (B, T); k_ctx/v_ctx: earlier chunks of the same layer;
    enc_kv: every row's cross keys and values (Whisper).
    Masked lanes (padding, unscheduled rows) keep their incoming residual;
    an MoE runs drop-free.  ``plane_mesh``: the window's queries
    sequence-sharded over the model axis
    (``_prefill_attn_layer_batched_cp``); an MLA layer runs replicated,
    as in the reference.  Returns (h_out, layer_kv) as ``layer_forward``
    gives it."""
    if plane_mesh is not None and cfg.attention_type != "mla":
        return _prefill_attn_layer_batched_cp(
            p, cfg, h, positions, token_mask, step_mask, k_ctx=k_ctx,
            v_ctx=v_ctx, q_offset=q_offset, enc_kv=enc_kv, pm=plane_mesh)
    x, kv_out = layer_forward(p, cfg, h, positions, enc_kv=enc_kv,
                              k_ctx=k_ctx, v_ctx=v_ctx, q_offset=q_offset,
                              return_kv=True, moe_drop_free=True)
    keep = token_mask[..., None] & step_mask[:, None, None]
    return torch.where(keep, x, h), kv_out


def _prefill_attn_layer_batched_cp(p: Dict, cfg: ModelConfig,
                                   h: torch.Tensor, positions: torch.Tensor,
                                   token_mask: torch.Tensor,
                                   step_mask: torch.Tensor, *, k_ctx, v_ctx,
                                   q_offset, enc_kv, pm):
    """The sequence-parallel GQA prefill layer, the reference's
    ``_prefill_attn_layer_batched_cp``: the projections and the epilogue
    run replicated on every rank, at the single-device shapes; rank r
    runs the ``flash_prefill`` kernel for its slice of T_loc queries at
    ``q_offset + r * T_loc`` against the whole window's keys and values
    (the quadratic part), and the attention outputs are gathered over
    the model group.  A window that does not divide the axis is padded
    with tail tokens that no real query sees (keys past every real
    position) and trimmed after."""
    n, r = pm.model_size, pm.model_rank
    B, T, _ = h.shape
    pad = (-T) % n
    hp = torch.nn.functional.pad(h, (0, 0, 0, pad)) if pad else h
    pos_p = (torch.cat([positions, positions[:, -1:].expand(B, pad)], 1)
             if pad else positions)
    T_loc = (T + pad) // n
    q, k, v = attn.gqa_project_qkv(p["attn"], cfg,
                                   _norm(cfg, p["attn_norm"], hp), pos_p)
    k_all, v_all = k, v
    if k_ctx is not None:
        k_all = torch.cat([k_ctx.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_ctx.to(v.dtype), v], dim=1)
    o = ops.flash_prefill(
        q[:, r * T_loc:(r + 1) * T_loc].contiguous(), k_all, v_all,
        scale=1.0 / cfg.head_dim ** 0.5, causal=True,
        q_offset=int(q_offset) + r * T_loc)
    o = mesh_mod.all_gather(o, 1, pm.model_group)
    x = hp + o.reshape(B, T + pad, -1) @ p["attn"]["wo"]
    if pad:
        x, k, v = x[:, :T], k[:, :T], v[:, :T]
    x, _ = _layer_epilogue(p, cfg, x, enc_kv, moe_drop_free=True)
    keep = token_mask[..., None] & step_mask[:, None, None]
    return torch.where(keep, x, h), (k, v)


def prefill_recurrent_layer_batched(p: Dict, cfg: ModelConfig, kind: str,
                                    h: torch.Tensor,
                                    token_mask: torch.Tensor,
                                    step_mask: torch.Tensor, rec_state: Dict):
    """One Mamba or RWKV layer over a padded batch of same-layer segments,
    from the rows' recurrent states ``rec_state``: the masked scan carries
    each row's state through its padding (``mamba_forward`` /
    ``rwkv_time_mix`` with ``token_mask``), a Mamba layer's FFN or MoE
    runs drop-free.  Returns (h_out, new_rec), both masked: masked lanes
    keep their incoming residual and parked rows their state."""
    if kind not in ("mamba", "rwkv"):
        raise NotImplementedError(f"recurrent layer kind {kind!r}")
    x, st = layer_forward(p, cfg, h, None, kind=kind, rec_state=rec_state,
                          token_mask=token_mask, moe_drop_free=True)
    keep = token_mask[..., None] & step_mask[:, None, None]
    return torch.where(keep, x, h), _mask_state(st, rec_state, step_mask)


def prefill_logits_batched(params: Dict, cfg: ModelConfig, h: torch.Tensor,
                           tok_len: torch.Tensor) -> torch.Tensor:
    """Each row's LAST REAL hidden state (h (B, S_cap, d), tok_len (B,))
    through the lm head -> (B, V)."""
    idx = (tok_len.long() - 1).clamp(min=0)
    h_last = h[torch.arange(h.shape[0], device=h.device), idx]
    return lm_head(params, cfg, h_last[:, None, :])[:, 0]


# ---------------------------------------------------------------------------
# Staged per-layer decode (select -> [host restore] -> attend)
# ---------------------------------------------------------------------------

def decode_embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens (B,) -> x (B, d)."""
    return params["embed"][tokens.long()]


def decode_select_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache,
                        cur_len: torch.Tensor,
                        step_mask: Optional[torch.Tensor] = None):
    """Select stage of one attention layer: pre-norm, project, append the
    token's KV and grow the metadata (in place), score + top-k.
    Returns (q, cache, idx, valid); q is MLA's absorbed query."""
    h_in = _norm(cfg, p["attn_norm"], x)
    select = (attn.mla_select_step if cfg.attention_type == "mla"
              else attn.gqa_select_step)
    return select(p["attn"], cfg, h_in, cache, cur_len, step_mask=step_mask)


def decode_attend_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                        q: torch.Tensor, cache, cur_len: torch.Tensor,
                        idx, valid, enc_kv=None) -> torch.Tensor:
    """Compute stage of one attention layer: block-sparse attention over
    the (possibly restored) pool + residual + cross-attention over
    ``enc_kv`` (Whisper) + FFN or MoE (drop-free).  Reads ``cache``
    only."""
    attend = (attn.mla_attend_step if cfg.attention_type == "mla"
              else attn.gqa_attend_step)
    x = x + attend(p["attn"], cfg, q, cache, cur_len, idx, valid)
    return _layer_epilogue(p, cfg, x, enc_kv, moe_drop_free=True)[0]


def decode_recurrent_layer(p: Dict, cfg: ModelConfig, kind: str,
                           x: torch.Tensor, cache: Dict,
                           step_mask: Optional[torch.Tensor] = None):
    """One Mamba or RWKV layer of a decode step as a single stage (no
    selection, no restore: it holds no paged KV): the mixer over the
    carried state, then the FFN or MoE (drop-free), or RWKV's time-mix
    then channel-mix.  Returns (x, new state), the state of parked rows
    (``step_mask`` False) unchanged."""
    if kind == "rwkv":                  # the window of one token
        y, new = layer_forward(p, cfg, x[:, None], None, kind="rwkv",
                               rec_state=cache)
        if step_mask is not None:
            new = _mask_state(new, cache, step_mask)
        return y[:, 0], new
    if kind != "mamba":
        raise NotImplementedError(f"recurrent layer kind {kind!r}")
    h, new = mamba_mod.mamba_decode_step(
        p["mamba"], cfg, _norm(cfg, p["attn_norm"], x), cache)
    if step_mask is not None:
        new = _mask_state(new, cache, step_mask)
    return _layer_epilogue(p, cfg, x + h, None, moe_drop_free=True)[0], new


def decode_logits(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  cur_len: torch.Tensor,
                  step_mask: Optional[torch.Tensor] = None):
    """lm head + cur_len advance (masked rows stay parked).
    Returns (logits (B, V), new_cur_len (B,))."""
    logits = lm_head(params, cfg, x[:, None, :])[:, 0]
    new_len = (cur_len + 1 if step_mask is None
               else cur_len + step_mask.to(cur_len.dtype))
    return logits, new_len


# ---------------------------------------------------------------------------
# Batched multi-request decode: padded-batch stack / unstack
# ---------------------------------------------------------------------------

def map_extra(fn, *trees):
    """``fn`` over the tensors of DecodeState ``extra`` trees of one
    structure (dicts, lists and tuples of tensors), leaf by leaf."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_extra(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(map_extra(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def extra_leaves(tree) -> List[torch.Tensor]:
    """The tensors of an ``extra`` tree, in order."""
    out: List[torch.Tensor] = []
    map_extra(out.append, tree)
    return out

def stack_decode_states(states: List[Dict]
                        ) -> Tuple[Dict, List[Tuple[int, List[int]]]]:
    """Stack per-request list-mode DecodeStates into ONE padded batch
    state: every layer's pools padded along the block axis to the batch's
    largest block count (``attention.pad_pool_cache``) and concatenated
    along batch (new tensors), the recurrent layers' states and the
    ``extra`` tensors (Whisper's enc_kvs) concatenated along batch, so the
    states must agree in their shapes but for batch (the engine groups
    them so).  Returns (batched_state, layout), the layout each input's
    (batch size, per-layer block counts, None for a recurrent layer) for
    ``unstack_decode_states``."""
    if not states:
        raise ValueError("stack_decode_states: empty batch")
    L = len(states[0]["caches"])
    layout = [(int(s["cur_len"].shape[0]),
               [int(c["k"].shape[2]) if is_pool_cache(c) else None
                for c in s["caches"]])
              for s in states]
    caches = []
    for l in range(L):
        parts = [s["caches"][l] for s in states]
        if is_pool_cache(parts[0]):
            nb_max = max(int(p["k"].shape[2]) for p in parts)
            parts = [attn.pad_pool_cache(p, nb_max) for p in parts]
        caches.append({key: torch.cat([p[key] for p in parts], dim=0)
                       for key in parts[0]})
    return {"caches": caches,
            "cur_len": torch.cat([s["cur_len"] for s in states], dim=0),
            "extra": (map_extra(lambda *xs: torch.cat(xs, dim=0),
                                *[s["extra"] for s in states])
                      if states[0]["extra"] else {})}, layout


def unstack_decode_states(state: Dict,
                          layout: List[Tuple[int, List[int]]]) -> List[Dict]:
    """Split a batched DecodeState back into per-request states, each pool
    trimmed to the request's own block count and copied out of the batch
    tensors (so no request keeps the batch alive); recurrent states are
    split by rows."""
    out: List[Dict] = []
    row = 0
    for B, nbs in layout:
        sl = slice(row, row + B)
        caches = []
        for l, c in enumerate(state["caches"]):
            own = {key: arr[sl] for key, arr in c.items()}
            if nbs[l] is not None:
                own = attn.slice_pool_cache(own, nbs[l])
            caches.append({key: arr.clone() for key, arr in own.items()})
        out.append({"caches": caches,
                    "cur_len": state["cur_len"][sl].clone(),
                    "extra": map_extra(lambda x: x[sl].clone(),
                                       state["extra"])})
        row += B
    return out


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: Dict, *, return_info: bool = False,
                step_mask: Optional[torch.Tensor] = None, plane_mesh=None):
    """tokens (B,) int32: one new token per request.  Updates the state's
    pools IN PLACE, puts each Mamba or RWKV layer's new state into
    ``state["caches"]`` (parked rows' unchanged), and returns (logits,
    state[, {"selected": {layer: idx}}]) with ``state["cur_len"]``
    advanced (a new tensor).  ``plane_mesh``
    (``launch.plane_mesh.PlaneMesh``): the context-parallel decode, the
    reference's fused ``plane_mesh`` path: ``state`` holds this rank's
    block shard of every attention layer's pools and metadata
    (``launch.sharding.decode_state_shard``), each attention layer's
    ``attention.gqa_decode_step`` / ``mla_decode_step`` runs over it (DSA
    on, no step_mask), everything else runs replicated, and the logits
    and selections come out the same on every rank.  Without one, each
    attention layer runs ``decode_select_layer`` then
    ``decode_attend_layer``, as the staged planes do."""
    cur_len = state["cur_len"]
    enc_kvs = state["extra"].get("enc_kvs")
    x = decode_embed(params, cfg, tokens)
    info: Dict[str, Any] = {"selected": {}}
    for i in range(cfg.num_layers):
        p = get_layer(params, i)
        kind = layer_kind(cfg, i)
        if kind != "attn":
            x, state["caches"][i] = decode_recurrent_layer(
                p, cfg, kind, x, state["caches"][i], step_mask)
            continue
        enc_kv = index_enc_kvs(enc_kvs, i)
        if plane_mesh is None:
            q, cache, idx, valid = decode_select_layer(
                p, cfg, x, state["caches"][i], cur_len, step_mask=step_mask)
            x = decode_attend_layer(p, cfg, x, q, cache, cur_len, idx, valid,
                                    enc_kv=enc_kv)
        else:
            step = (attn.mla_decode_step if cfg.attention_type == "mla"
                    else attn.gqa_decode_step)
            h, _, idx = step(p["attn"], cfg, _norm(cfg, p["attn_norm"], x),
                             state["caches"][i], cur_len,
                             plane_mesh=plane_mesh, step_mask=step_mask)
            x = _layer_epilogue(p, cfg, x + h, enc_kv, moe_drop_free=True)[0]
        if idx is not None:
            info["selected"][i] = idx
    logits, new_len = decode_logits(params, cfg, x, cur_len, step_mask)
    new_state = {"caches": state["caches"], "cur_len": new_len,
                 "extra": state["extra"]}
    if return_info:
        return logits, new_state, info
    return logits, new_state
