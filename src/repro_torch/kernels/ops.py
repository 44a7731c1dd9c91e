"""Wrappers of the port's hand-written Hopper kernels.

Each wrapper decides by the device of the tensors it is given: when every
one of them lies on the CPU it returns the plain PyTorch version from
``ref.py`` (what the CPU tests run); otherwise it checks device, dtype,
shape and contiguity (a mix of devices that the kernel does not take
raises)
(the kernels take bfloat16 activations and pools, as the serving path
holds them on the GPU, and the int8 tier's int8 payloads with float32
scales),
allocates its output with ``torch.empty``, launches the CUDA kernel on
``torch.cuda.current_stream()`` and raises if the launch returned an error.
There is no fallback from a CUDA tensor to the plain version.

``launches`` counts kernel launches per wrapper (plain-version calls are not
counted), so a run can show that its main path went through the kernels.

Block ids that a caller holds on the host (a list, a numpy array or a CPU
tensor) are range-checked there, on both paths, and a wrapper raises
``IndexError`` on one out of range before anything is uploaded or written.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.kernels import ref
from repro_torch.kernels.build import LIBS

_PAYLOAD_CODES = {torch.float32: 0, torch.bfloat16: 1}   # common.cuh DType


class LaunchCounter:
    """Kernel launches per wrapper name since the last ``reset``; a
    launch of a kernel's other mode or instance also counts under
    "name:mode" (score_select's "mean" and "sum" scorings, the training
    instances of flash_prefill and flash_prefill_bwd, the recurrences'
    training forwards)."""

    NAMES = ("sparse_decode_attention", "block_score", "score_select",
             "gather_blocks_hkv", "scatter_blocks_hkv", "zero_blocks_hkv",
             "write_blocks_hkv", "flash_prefill", "quantize_blocks",
             "dequantize_blocks", "dequantize_scatter_blocks",
             "quant_save_blocks", "gather_blocks", "scatter_blocks",
             "selective_scan", "wkv6", "flash_prefill_bwd", "wkv6_bwd",
             "selective_scan_bwd")

    def __init__(self):
        self.counts: Dict[str, int] = dict.fromkeys(self.NAMES, 0)

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.NAMES, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)

    def add(self, name: str, *modes: Optional[str]) -> None:
        self.counts[name] += 1
        for mode in filter(None, modes):
            key = f"{name}:{mode}"
            self.counts[key] = self.counts.get(key, 0) + 1


launches = LaunchCounter()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _all_cpu(*tensors) -> bool:
    """Whether every tensor given lies on the CPU (None and host-held
    ids, lists or numpy arrays, skipped): the one case in which a wrapper
    takes its plain version."""
    return all(not isinstance(t, torch.Tensor) or t.device.type == "cpu"
               for t in tensors)


HostIds = Union[Sequence[int], np.ndarray, torch.Tensor]


def _host_ids(name: str, ids) -> Optional[np.ndarray]:
    """Ids the caller holds on the host as an int64 numpy array; None for
    ids already on a device (a tensor not on the CPU)."""
    if isinstance(ids, torch.Tensor):
        if ids.device.type != "cpu":
            return None
        ids = ids.numpy()
    a = np.asarray(ids)
    _check(a.ndim == 1 and (a.size == 0 or np.issubdtype(a.dtype,
                                                         np.integer)),
           f"{name}: ids must be a 1-D integer sequence")
    return a.astype(np.int64, copy=False)


def _check_range(name: str, what: str, ids: np.ndarray, n: int) -> None:
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        bad = ids[(ids < 0) | (ids >= n)][0]
        raise IndexError(f"{name}: {what} id {int(bad)} out of range "
                         f"[0, {n})")


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    _check(device.type == "cuda", f"{name}: tensors on {device}")
    for tname, t in tensors.items():
        _check(t.device == device,
               f"{name}: {tname} is on {t.device}, expected {device}")
        _check(t.is_contiguous(), f"{name}: {tname} must be contiguous")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _check_host_or(name: str, pool: torch.Tensor, dev: torch.device) -> bool:
    """A pool for a kernel on ``dev``: pinned host memory (returns True) or
    a tensor on ``dev`` (False)."""
    if pool.device.type == "cpu":
        _check(pool.is_pinned(),
               f"{name}: a host pool must be in pinned memory")
        return True
    _check(pool.device == dev, f"{name}: pool on {pool.device}, expected "
                               f"{dev}")
    return False


# ---------------------------------------------------------------------------
# sparse_decode_attention
# ---------------------------------------------------------------------------

# the longest run of blocks one CTA of the split-K attention walks: the
# blocks of a run are walked in turn, so shorter runs shorten the kernel
# where B * Hkv alone would already fill the card
DECODE_RUN = 4
# query rows of one group tile of the decode attention (the kernel's
# kTileG): a GQA group of G rows takes ceil(G / DECODE_TILE_G) CTAs per
# split
DECODE_TILE_G = 16


def decode_group_tiles(G: int) -> int:
    """Group tiles of the decode attention for a GQA group of G rows."""
    return -(-G // DECODE_TILE_G)


def decode_splits(B: int, Hkv: int, K: int, sms: int, tiles: int = 1) -> int:
    """Splits of the K selected blocks across CTAs (flash-decoding): enough
    that B * Hkv * tiles * splits >= 2 * sms where K allows it (``tiles``:
    the group tiles of each (request, kv-head)), and runs of at most
    DECODE_RUN blocks, each split a run of ceil(K / splits) blocks, no
    split empty by construction."""
    if K == 0:
        return 1
    want = min(K, max(-(-2 * sms // max(1, B * Hkv * tiles)),
                      -(-K // DECODE_RUN)))
    per = -(-K // want)
    return -(-K // per)


_SM_COUNTS: Dict[torch.device, int] = {}


def _sm_count(dev: torch.device) -> int:
    if dev not in _SM_COUNTS:
        _SM_COUNTS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNTS[dev]


# the widest head the decode attention takes (D and Dv; its wide
# instantiation, which MLA's 288-wide latent runs), and score_select's
DECODE_MAX_D = 320
SELECT_MAX_D = 320


def _decode_launch_args(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_idx: torch.Tensor,
                        sel_valid: torch.Tensor, cur_len: torch.Tensor,
                        scale: Optional[float]):
    """The decode attention's checks, split count and float32 split
    partials (both of its modes): returns (shapes (B, Hkv, NB, bs, D,
    Dv, K, G), splits, scale, part_o, part_ml)."""
    B, Hq, D = q.shape
    _, Hkv, NB, bs, _ = k_pool.shape
    Dv = v_pool.shape[-1]
    K = block_idx.shape[-1]
    _check_cuda(name, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
                block_idx=block_idx, sel_valid=sel_valid, cur_len=cur_len)
    _check(q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16,
           f"{name}: q, k_pool and v_pool must be bfloat16")
    _check(block_idx.dtype == torch.int32 and sel_valid.dtype == torch.bool
           and cur_len.dtype == torch.int32,
           f"{name}: block_idx int32, sel_valid bool, cur_len int32")
    _check(k_pool.shape[0] == B and v_pool.shape[:4] == k_pool.shape[:4]
           and k_pool.shape[-1] == D and Hq % Hkv == 0
           and block_idx.shape == (B, Hkv, K)
           and sel_valid.shape == (B, Hkv, K) and cur_len.shape == (B,),
           f"{name}: inconsistent shapes")
    vec = 16 // q.element_size()
    _check(D <= DECODE_MAX_D and Dv <= DECODE_MAX_D and bs <= 128
           and D % vec == 0 and Dv % vec == 0,
           f"{name}: needs D, Dv <= {DECODE_MAX_D} in 16-byte multiples "
           f"(D = {D}, Dv = {Dv}) and bs <= 128 (bs = {bs}); any GQA group")
    _check(_aligned(q, k_pool, v_pool), f"{name}: 16-byte alignment")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    G = Hq // Hkv
    splits = decode_splits(B, Hkv, K, _sm_count(q.device),
                           decode_group_tiles(G))
    smem = LIBS.fn("sparse_decode_attention_smem")(G, D, Dv, bs, K, splits)
    _check(smem <= SMEM_OPTIN_BYTES,
           f"{name}: {smem} bytes of shared memory at D = {D}, Dv = {Dv}, "
           f"bs = {bs}; the card gives {SMEM_OPTIN_BYTES}")
    # each split's unnormalised float32 partial: acc (G, Dv), then m and l
    part_o = torch.empty((B, Hkv, splits, G, Dv), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B, Hkv, splits, 2, G), dtype=torch.float32,
                          device=q.device)
    return (B, Hkv, NB, bs, D, Dv, K, G), splits, scale, part_o, part_ml


def sparse_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_idx: torch.Tensor,
                            sel_valid: torch.Tensor, cur_len: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); pools (B, Hkv, NB, bs, D|Dv); block_idx int32 and
    sel_valid bool (B, Hkv, K); cur_len int32 (B,) -> (B, Hq, Dv).  MLA
    passes its latent pool as both pools, with its own ``scale``."""
    if _all_cpu(q, k_pool, v_pool, block_idx, sel_valid, cur_len):
        return ref.sparse_decode_attention(q, k_pool, v_pool, block_idx,
                                           sel_valid, cur_len, scale)
    name = "sparse_decode_attention"
    dims, splits, scale, part_o, part_ml = _decode_launch_args(
        name, q, k_pool, v_pool, block_idx, sel_valid, cur_len, scale)
    B, Hq, Dv = q.shape[0], q.shape[1], dims[5]
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    rc = LIBS.fn(name)(
        q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_idx.data_ptr(), sel_valid.data_ptr(),
        cur_len.data_ptr(), out.data_ptr(), part_o.data_ptr(),
        part_ml.data_ptr(), *dims, splits, float(scale), _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


def sparse_decode_attention_partial(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_idx: torch.Tensor, sel_valid: torch.Tensor,
        cur_len: torch.Tensor, block_offset: int,
        scale: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The context-parallel decode's partial mode: one rank's share over
    its block shard (pools (B, Hkv, NB_loc, bs, D|Dv), block_idx LOCAL
    ids, validity at GLOBAL positions through ``block_offset``, the
    global id of the shard's block 0) -> float32 (acc (B, Hq, Dv), m
    (B, Hq), l (B, Hq)), unnormalised, for the ranks' log-sum-exp merge
    (``ref.sparse_decode_attention_partial``).  The same split kernel as
    ``sparse_decode_attention``; its merge writes the partials in place
    of the normalised bf16 output.  Counted as
    "sparse_decode_attention:partial"."""
    if _all_cpu(q, k_pool, v_pool, block_idx, sel_valid, cur_len):
        return ref.sparse_decode_attention_partial(
            q, k_pool, v_pool, block_idx, sel_valid, cur_len, block_offset,
            scale)
    name = "sparse_decode_attention"
    dims, splits, scale, part_o, part_ml = _decode_launch_args(
        name, q, k_pool, v_pool, block_idx, sel_valid, cur_len, scale)
    B, Hq, Dv = q.shape[0], q.shape[1], dims[5]
    _check(block_offset >= 0, f"{name}: block_offset >= 0")
    acc = torch.empty((B, Hq, Dv), dtype=torch.float32, device=q.device)
    ml = torch.empty((2, B, Hq), dtype=torch.float32, device=q.device)
    rc = LIBS.fn("sparse_decode_attention:partial")(
        q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_idx.data_ptr(), sel_valid.data_ptr(),
        cur_len.data_ptr(), acc.data_ptr(), ml.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), *dims, splits,
        int(block_offset), float(scale), _stream())
    _raise_on(rc, name)
    launches.add(name, "partial")
    return acc, ml[0], ml[1]


# ---------------------------------------------------------------------------
# block_score
# ---------------------------------------------------------------------------

# Dynamic shared memory a block may opt in to on the H100 (227 KB of the
# SM's 256; the kernels' few static bytes lie under the 4 KB kept back).
# block_score holds the GQA group's q rows as pos / neg float32 (8 * G * D
# bytes); score_select those and every block's key (4 * NB bytes) in
# every CTA of its cluster.
SMEM_OPTIN_BYTES = 232_448 - 4096


# the widest head block_score takes: its narrow instance up to D = 128
# (the GQA heads), its wide one up to 320 (MLA's 288-wide latent, scored
# by the context-parallel decode)
SCORE_NARROW_D = 128
SCORE_MAX_D = 320


def block_score(q: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D); meta (B, Hkv, NB, 2, D) float32, [min, max] interleaved
    -> (B, Hkv, NB) float32 cuboid bounds, max over the GQA group.  A D
    above SCORE_NARROW_D runs the wide instance (counted as
    "block_score:wide")."""
    if _all_cpu(q, meta):
        return ref.block_score(q, meta)
    name = "block_score"
    B, Hq, D = q.shape
    _, Hkv, NB, two, Dm = meta.shape
    _check_cuda(name, q.device, q=q, meta=meta)
    _check(q.dtype == torch.bfloat16 and meta.dtype == torch.float32,
           f"{name}: q bfloat16, meta float32")
    _check(meta.shape[0] == B and two == 2 and Dm == D and Hq % Hkv == 0,
           f"{name}: inconsistent shapes")
    G = Hq // Hkv
    _check(D <= SCORE_MAX_D and D % 4 == 0
           and 8 * G * D <= SMEM_OPTIN_BYTES,
           f"{name}: needs D <= {SCORE_MAX_D}, D % 4 == 0 and 8 * G * D = "
           f"{8 * G * D} bytes of shared memory <= {SMEM_OPTIN_BYTES}")
    _check(_aligned(meta), f"{name}: meta 16-byte aligned")
    out = torch.empty((B, Hkv, NB), dtype=torch.float32, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), meta.data_ptr(), out.data_ptr(), B, Hkv,
                       NB, D, G, _stream())
    _raise_on(rc, name)
    launches.add(name, "wide" if D > SCORE_NARROW_D else None)
    return out


# ---------------------------------------------------------------------------
# score_select: block_score fused with the top-k select
# ---------------------------------------------------------------------------

def select_max_nb(G: int, D: int) -> int:
    """The largest NB score_select takes for a GQA group of G rows of
    width D (0 where the q rows alone do not fit)."""
    return max(0, (SMEM_OPTIN_BYTES - 8 * G * D) // 4)


SCORINGS = (("cuboid", "max"), ("cuboid", "sum"), ("mean", "max"),
            ("mean", "sum"))


def score_select(q: torch.Tensor, meta: torch.Tensor, cur_len: torch.Tensor,
                 *, block_size: int, top_k: int, sink_blocks: int,
                 recent_blocks: int, metadata: str = "cuboid",
                 group_reduce: str = "max"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode select stage in one launch: the score of every block
    (``ref.block_score``: the cuboid bound from meta (B, Hkv, NB, 2, D), or
    with ``metadata="mean"`` q . mean from meta (B, Hkv, NB, D), float32;
    max over the GQA group, or its sum with ``group_reduce="sum"``) and
    the DSA top-k over the cache once this step's token is appended,
    cur_len (B,) int32 tokens before it (the +1 is added in the kernel).
    q (B, Hq, D) -> (idx (B, Hkv, K) int32, sel_valid (B, Hkv, K) bool),
    K = min(top_k, NB), invalid ids replaced by 0.  The kernel orders the
    ids by score, highest first, ties by block id, lowest first; the plain
    version (``torch.topk``) may order them otherwise.  On the GPU: NB <=
    ``select_max_nb(G, D)``."""
    _check((metadata, group_reduce) in SCORINGS,
           f"score_select: no scoring {metadata!r} with the "
           f"{group_reduce!r} reduction")
    kw = dict(block_size=block_size, top_k=top_k, sink_blocks=sink_blocks,
              recent_blocks=recent_blocks, metadata=metadata,
              group_reduce=group_reduce)
    if _all_cpu(q, meta, cur_len):
        return ref.score_select(q, meta, cur_len, **kw)
    name = "score_select"
    mean = metadata == "mean"
    B, Hq, D = q.shape
    Hkv, NB, Dm = meta.shape[1], meta.shape[2], meta.shape[-1]
    _check_cuda(name, q.device, q=q, meta=meta, cur_len=cur_len)
    _check(q.dtype == torch.bfloat16 and meta.dtype == torch.float32
           and cur_len.dtype == torch.int32,
           f"{name}: q bfloat16, meta float32, cur_len int32")
    _check(meta.shape[0] == B and Dm == D and Hkv > 0 and Hq % Hkv == 0
           and cur_len.shape == (B,)
           and (meta.dim() == 4 if mean
                else meta.dim() == 5 and meta.shape[3] == 2),
           f"{name}: inconsistent shapes")
    G = Hq // Hkv
    _check(D <= SELECT_MAX_D and D % 4 == 0,
           f"{name}: needs D <= {SELECT_MAX_D} and D % 4 == 0 (D = {D})")
    _check(1 <= NB <= select_max_nb(G, D),
           f"{name}: NB = {NB} at G = {G}, D = {D}; the kernel takes 1 <= "
           f"NB <= {select_max_nb(G, D)} (8 * G * D + 4 * NB bytes of "
           f"shared memory <= {SMEM_OPTIN_BYTES})")
    _check(block_size > 0 and top_k > 0 and sink_blocks >= 0
           and recent_blocks >= 0, f"{name}: bad DSA parameters")
    _check(_aligned(meta), f"{name}: meta 16-byte aligned")
    K = min(top_k, NB)
    idx = torch.empty((B, Hkv, K), dtype=torch.int32, device=q.device)
    valid = torch.empty((B, Hkv, K), dtype=torch.bool, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), meta.data_ptr(), cur_len.data_ptr(),
                       idx.data_ptr(), valid.data_ptr(), B, Hkv, NB, D, G,
                       K, block_size, sink_blocks, recent_blocks, int(mean),
                       int(group_reduce == "sum"), _stream())
    _raise_on(rc, name)
    launches.add(name, "sum" if group_reduce == "sum"
                 else "mean" if mean else None)
    return idx, valid


# ---------------------------------------------------------------------------
# gather_blocks_hkv
# ---------------------------------------------------------------------------

def gather_blocks_hkv(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool (H, NB, bs, D), idx (K,) int32 -> (H, K, bs, D) on idx's device.

    On the GPU the pool may lie in pinned host memory: the kernel then
    reads it in place (FlashH2D), and the result lands in device memory.
    Any element type: blocks move as bytes (whole 4-byte words)."""
    if _all_cpu(pool, idx):
        return ref.gather_blocks_hkv(pool, idx)
    name = "gather_blocks_hkv"
    _check(idx.device.type == "cuda",
           f"{name}: idx on {idx.device} for a pool on {pool.device}")
    H, NB, bs, D = pool.shape
    K = idx.shape[0]
    on_host = _check_host_or(name, pool, idx.device)
    _check(pool.is_contiguous() and idx.is_contiguous()
           and idx.dtype == torch.int32 and idx.dim() == 1,
           f"{name}: contiguous pool, 1-D int32 idx")
    block_bytes = bs * D * pool.element_size()
    _check(block_bytes % 4 == 0 and pool.data_ptr() % 4 == 0,
           f"{name}: blocks must be whole 4-byte words")
    out = torch.empty((H, K, bs, D), dtype=pool.dtype, device=idx.device)
    storage = pool.untyped_storage()
    base = storage.data_ptr()
    rc = LIBS.fn(name)(
        base, pool.data_ptr() - base, int(on_host), idx.data_ptr(),
        out.data_ptr(), H, NB, K, block_bytes, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


# ---------------------------------------------------------------------------
# scatter_blocks_hkv
# ---------------------------------------------------------------------------

def scatter_blocks_hkv(pool: torch.Tensor, payload: torch.Tensor,
                       dest_blocks: HostIds,
                       rows: Optional[HostIds] = None) -> torch.Tensor:
    """Scatter payload (H, K, bs, D) into ``pool`` IN PLACE, cast to the
    pool's dtype: pool (H, NB, bs, D) with rows None, or
    (B, H, NB, bs, D) with rows (K,).  Returns ``pool``.

    Ids are host-held (a list, numpy array or CPU tensor: checked against
    NB and B, IndexError on one out of range, then uploaded in one copy on
    the GPU path) or int32 tensors on the pool's device, which the caller
    has checked (the kernel skips an id out of range).  On the GPU the
    pool is bfloat16 on the payload's device and the payload float32 (a
    restore from the host pool) or bfloat16."""
    name = "scatter_blocks_hkv"
    dest_h = _host_ids(name, dest_blocks)
    rows_h = None if rows is None else _host_ids(name, rows)
    if rows is None:
        NB = pool.shape[1]
    else:
        NB = pool.shape[2]
        if rows_h is not None:
            _check_range(name, "row", rows_h, pool.shape[0])
    if dest_h is not None:
        _check_range(name, "block", dest_h, NB)
    if _all_cpu(pool, payload, dest_blocks, rows):
        return ref.scatter_blocks_hkv(
            pool, payload, torch.from_numpy(dest_h),
            None if rows is None else torch.from_numpy(rows_h))
    _check(payload.device.type == "cuda" and pool.device == payload.device,
           f"{name}: pool on {pool.device}, payload on {payload.device}")
    dev = pool.device
    if rows is None:
        H, NB, bs, D = pool.shape
        B, row_stride = 1, 0
        head_stride, block_stride = pool.stride(0), pool.stride(1)
    else:
        B, H, NB, bs, D = pool.shape
        row_stride, head_stride, block_stride = pool.stride()[:3]
    if dest_h is not None and (rows is None or rows_h is not None):
        # every id host-held: one upload, [blocks, rows]
        ids = host_to_device(dest_h if rows is None
                             else np.concatenate([dest_h, rows_h]), dev)
        K = dest_h.shape[0]
        dest_blocks = ids[:K]
        rows = None if rows is None else ids[K:]
    else:
        _check(isinstance(dest_blocks, torch.Tensor)
               and isinstance(rows, (torch.Tensor, type(None))),
               f"{name}: blocks and rows both host-held or both tensors")
        _check_cuda(name, dev, dest_blocks=dest_blocks)
        if rows is not None:
            _check_cuda(name, dev, rows=rows)
            _check(rows.dtype == torch.int32, f"{name}: rows must be int32")
        _check(dest_blocks.dtype == torch.int32,
               f"{name}: block ids must be int32")
        K = dest_blocks.shape[0]
    _check_cuda(name, dev, payload=payload)
    _check(pool.stride(-1) == 1 and pool.stride(-2) == D,
           f"{name}: each pool block must be contiguous")
    _check(payload.shape == (H, K, bs, D)
           and (rows is None or rows.shape == (K,)),
           f"{name}: payload must be (H, K, bs, D) = {(H, K, bs, D)}")
    _check(pool.dtype == torch.bfloat16 and payload.dtype in _PAYLOAD_CODES,
           f"{name}: bfloat16 pool, float32/bfloat16 payload")
    rc = LIBS.fn(name)(
        _PAYLOAD_CODES[payload.dtype], payload.data_ptr(),
        None if rows is None else rows.data_ptr(),
        dest_blocks.data_ptr(), pool.data_ptr(), row_stride, head_stride,
        block_stride, B, H, NB, K, bs * D, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return pool


# ---------------------------------------------------------------------------
# zero_blocks_hkv: an eviction round's drops in one launch
# ---------------------------------------------------------------------------

class PoolTable:
    """Pools of one shape, dtype, device and strides (K and V of every layer
    of a decode plane), indexed by position, and on the GPU the device
    table of their base addresses that ``zero_blocks_hkv`` reads, uploaded
    once here: build it when the pools are allocated, not per call.  Keeps
    the pools alive while it lives.  Raises ValueError on pools that
    differ, lie on a mix of devices, or (on the GPU) are not bfloat16 with
    16-byte aligned, contiguous blocks."""

    def __init__(self, pools: Sequence[torch.Tensor]):
        name = "zero_blocks_hkv"
        self.pools = tuple(pools)
        _check(len(self.pools) > 0, f"{name}: an empty pool table")
        p0 = self.pools[0]
        _check(p0.dim() == 5, f"{name}: pools must be (B, H, NB, bs, D)")
        for p in self.pools:
            _check(p.device == p0.device,
                   f"{name}: pools on {p.device} and {p0.device}")
            _check(p.shape == p0.shape and p.dtype == p0.dtype
                   and p.stride() == p0.stride(),
                   f"{name}: every pool of the table needs the first one's "
                   f"shape, dtype and strides")
        self.ptrs: Optional[torch.Tensor] = None
        if p0.device.type == "cpu":
            return
        _check(p0.device.type == "cuda",
               f"{name}: pools on {p0.device}")
        B, H, NB, bs, D = p0.shape
        esz = p0.element_size()
        _check(p0.dtype == torch.bfloat16, f"{name}: pools must be bfloat16")
        _check(p0.stride(-1) == 1 and p0.stride(-2) == D
               and all(st * esz % 16 == 0 for st in p0.stride()[:3])
               and bs * D * esz % 16 == 0 and _aligned(*self.pools),
               f"{name}: contiguous blocks of 16-byte multiples, 16-byte "
               f"aligned pools and strides")
        self.ptrs = host_to_device([p.data_ptr() for p in self.pools],
                                   p0.device, torch.int64)

    def __len__(self) -> int:
        return len(self.pools)

    @property
    def device(self) -> torch.device:
        return self.pools[0].device


def zero_blocks_hkv(pools: Union[PoolTable, Sequence[torch.Tensor]],
                    which: HostIds, rows: HostIds, blocks: HostIds
                    ) -> Sequence[torch.Tensor]:
    """Zero block ``blocks[i]`` of batch row ``rows[i]``, every head, of
    pool ``pools[which[i]]``, IN PLACE, for every i: pools (B, H, NB, bs,
    D) of one shape and strides (a ``PoolTable``, or a sequence made into
    one); which, rows and blocks host-held (N,) ids, checked against the
    table's length, B and NB (IndexError on one out of range), packed and
    uploaded in one copy on the GPU path.  One launch.  Returns the
    pools."""
    name = "zero_blocks_hkv"
    table = pools if isinstance(pools, PoolTable) else PoolTable(pools)
    ids = [_host_ids(name, a) for a in (which, rows, blocks)]
    _check(all(a is not None for a in ids),
           f"{name}: ids must be host-held (a list, numpy array or CPU "
           f"tensor), so they are checked before the upload")
    which_h, rows_h, blocks_h = ids
    N = which_h.shape[0]
    _check(rows_h.shape == (N,) and blocks_h.shape == (N,),
           f"{name}: which, rows and blocks of one length")
    B, H, NB, bs, D = table.pools[0].shape
    _check_range(name, "pool", which_h, len(table))
    _check_range(name, "row", rows_h, B)
    _check_range(name, "block", blocks_h, NB)
    if table.ptrs is None:
        return ref.zero_blocks_hkv(table.pools, *(torch.from_numpy(a)
                                                  for a in ids))
    if N == 0:
        return table.pools
    items = host_to_device(np.stack([which_h, rows_h, blocks_h], axis=1),
                           table.device)
    esz = table.pools[0].element_size()
    row_stride, head_stride, block_stride = (
        st * esz for st in table.pools[0].stride()[:3])
    rc = LIBS.fn(name)(table.ptrs.data_ptr(), items.data_ptr(), N, H,
                       row_stride, head_stride, block_stride, bs * D * esz,
                       _stream())
    _raise_on(rc, name)
    launches.add(name)
    return table.pools


# ---------------------------------------------------------------------------
# write_blocks_hkv
# ---------------------------------------------------------------------------

def write_blocks_hkv(pool: torch.Tensor, payload: torch.Tensor,
                     dest_blocks: torch.Tensor) -> torch.Tensor:
    """Write payload (H, K, bs, D) into blocks ``dest_blocks`` of ``pool``
    (H, NB, bs, D) IN PLACE, byte for byte (the same dtype on both sides).
    Returns ``pool``.

    On the GPU (a CUDA payload) the pool may lie in pinned host memory: the
    kernel then writes it in place through its device-mapped address (the
    int8 tier's write back into the DRAM pool, payload and scales)."""
    if _all_cpu(pool, payload, dest_blocks):
        return ref.write_blocks_hkv(pool, payload, dest_blocks)
    name = "write_blocks_hkv"
    _check(payload.device.type == "cuda",
           f"{name}: payload on {payload.device} for a pool on "
           f"{pool.device}")
    H, NB, bs, D = pool.shape
    K = dest_blocks.shape[0]
    on_host = _check_host_or(name, pool, payload.device)
    _check_cuda(name, payload.device, payload=payload,
                dest_blocks=dest_blocks)
    _check(pool.dtype == payload.dtype and pool.stride(-1) == 1
           and pool.stride(-2) == D and payload.shape == (H, K, bs, D)
           and dest_blocks.dtype == torch.int32,
           f"{name}: payload of the pool's dtype, contiguous pool blocks, "
           f"payload (H, K, bs, D) = {(H, K, bs, D)}, int32 ids")
    esz = pool.element_size()
    block_bytes = bs * D * esz
    _check(block_bytes % 4 == 0 and pool.data_ptr() % 4 == 0
           and payload.data_ptr() % 4 == 0,
           f"{name}: blocks must be whole 4-byte words")
    base = pool.untyped_storage().data_ptr()
    rc = LIBS.fn(name)(
        payload.data_ptr(), dest_blocks.data_ptr(), base,
        pool.data_ptr() - base, int(on_host), pool.stride(0) * esz,
        pool.stride(1) * esz, H, NB, K, block_bytes, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return pool


# ---------------------------------------------------------------------------
# gather_blocks / scatter_blocks: the flat (NB, bs, D) FlashH2D / FlashD2H
# ---------------------------------------------------------------------------

def gather_blocks(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool (NB, bs, D), idx (K,) int32 -> (K, bs, D) on idx's device, any
    element type, byte for byte.

    On the GPU the pool may lie in pinned host memory: the kernel then
    reads it in place, so the gather is the host-to-device transfer of the
    fragmented blocks in one launch (FlashH2D)."""
    if _all_cpu(pool, idx):
        return ref.gather_blocks(pool, idx)
    name = "gather_blocks"
    _check(idx.device.type == "cuda",
           f"{name}: idx on {idx.device} for a pool on {pool.device}")
    NB, bs, D = pool.shape
    K = idx.shape[0]
    on_host = _check_host_or(name, pool, idx.device)
    _check(pool.is_contiguous() and idx.is_contiguous()
           and idx.dtype == torch.int32 and idx.dim() == 1,
           f"{name}: contiguous pool, 1-D int32 idx")
    block_bytes = bs * D * pool.element_size()
    _check(block_bytes % 4 == 0 and pool.data_ptr() % 4 == 0,
           f"{name}: blocks must be whole 4-byte words")
    out = torch.empty((K, bs, D), dtype=pool.dtype, device=idx.device)
    base = pool.untyped_storage().data_ptr()
    rc = LIBS.fn(name)(base, pool.data_ptr() - base, int(on_host),
                       idx.data_ptr(), out.data_ptr(), NB, K, block_bytes,
                       _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


def scatter_blocks(pool: torch.Tensor, new_kv: torch.Tensor,
                   dest: torch.Tensor) -> torch.Tensor:
    """Place new_kv (n_new * bs, D), contiguous, into blocks ``dest``
    (n_new,) int32 of pool (NB, bs, D) IN PLACE, byte for byte (the same
    dtype on both sides); untouched blocks persist.  Returns ``pool`` (the
    reference returns a new array).

    On the GPU (a CUDA new_kv) the pool may lie in pinned host memory: the
    kernel then writes it through its device-mapped address, the second
    phase of FlashD2H."""
    if _all_cpu(pool, new_kv, dest):
        return ref.scatter_blocks(pool, new_kv, dest)
    name = "scatter_blocks"
    _check(new_kv.device.type == "cuda",
           f"{name}: new_kv on {new_kv.device} for a pool on {pool.device}")
    NB, bs, D = pool.shape
    n_new = dest.shape[0]
    on_host = _check_host_or(name, pool, new_kv.device)
    _check_cuda(name, new_kv.device, new_kv=new_kv, dest=dest)
    _check(pool.is_contiguous() and new_kv.dtype == pool.dtype
           and tuple(new_kv.shape) == (n_new * bs, D)
           and dest.dtype == torch.int32 and dest.dim() == 1,
           f"{name}: contiguous pool, new_kv (n_new * bs, D) = "
           f"{(n_new * bs, D)} of the pool's dtype, 1-D int32 ids")
    block_bytes = bs * D * pool.element_size()
    _check(block_bytes % 4 == 0 and pool.data_ptr() % 4 == 0
           and new_kv.data_ptr() % 4 == 0,
           f"{name}: blocks must be whole 4-byte words")
    base = pool.untyped_storage().data_ptr()
    rc = LIBS.fn(name)(new_kv.data_ptr(), dest.data_ptr(), base,
                       pool.data_ptr() - base, int(on_host), NB, n_new,
                       block_bytes, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return pool


# ---------------------------------------------------------------------------
# flash_prefill
# ---------------------------------------------------------------------------

# the (q/k depth, v width) pairs the kernel is built for: D = Dv of the
# GQA heads (112: kimi-k2's 7168 / 64), and MLA's prefill (qk_nope +
# qk_rope = 96 against v 64)
FLASH_DIMS = ((64, 64), (128, 128), (96, 64), (112, 112))


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True,
                  q_offset: int = 0) -> torch.Tensor:
    """Prefill attention: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D|Dv) ->
    (B, Sq, Hq, Dv) in q's dtype.  Causal: q_offset is the absolute
    position of q[0] (earlier chunks' keys lie ahead of the window, Sk =
    q_offset + Sq on the serving path).  ``causal=False`` (Whisper's
    encoder and cross-attention): every query sees every key j < Sk and
    q_offset is ignored, as in the reference's
    ``flash_attention_jnp(causal=False)``.  On the GPU: bfloat16, (D, Dv)
    in ``FLASH_DIMS``, either mode.

    Training's calls go through ``FlashPrefillFn`` (the forward with each
    row's log-sum-exp, and ``flash_prefill_bwd`` on the backward pass):
    those with grad enabled and q, k or v requiring grad, in either mode
    over whole sequences (``_check_backward_limits``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_backward_limits(q, k, v, causal, q_offset)
        return FlashPrefillFn.apply(q, k, v, float(scale), bool(causal))
    if _all_cpu(q, k, v):
        return ref.flash_prefill(q, k, v, scale=scale, causal=causal,
                                 q_offset=q_offset)
    name = "flash_prefill"
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    q_offset = int(q_offset) if causal else 0
    _check_flash(name, q, k, v, q_offset)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), None, B, Sq, Sk, Hq, Hkv, D, Dv,
                       q_offset, int(causal), float(scale), _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


def _check_flash(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, q_offset: int) -> None:
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    _check_cuda(name, q.device, q=q, k=k, v=v)
    _check(q.dtype == k.dtype == v.dtype == torch.bfloat16,
           f"{name}: q, k and v must be bfloat16")
    _check(k.shape == (B, Sk, Hkv, D) and Hkv > 0 and Hq % Hkv == 0
           and (D, Dv) in FLASH_DIMS and q_offset >= 0,
           f"{name}: needs k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), "
           f"Hq % Hkv == 0, (D, Dv) in {FLASH_DIMS} (got {(D, Dv)}), "
           f"q_offset >= 0")
    _check(_aligned(q, k, v), f"{name}: 16-byte alignment")


# the (q/k depth, v width) pairs the backward is built for: the dense GQA
# family's heads (qwen2-0.5b's 64, llama3-8b's 128), MLA's (96, 64) and
# kimi-k2's (112, 112); its non-causal mode at Whisper's 64 only
FLASH_BWD_DIMS = ((64, 64), (128, 128), (96, 64), (112, 112))
FLASH_BWD_NONCAUSAL_DIMS = ((64, 64),)


def _bwd_dims(causal: bool) -> Tuple[Tuple[int, int], ...]:
    return FLASH_BWD_DIMS if causal else FLASH_BWD_NONCAUSAL_DIMS


def _check_backward_limits(q, k, v, causal: bool, q_offset) -> None:
    """What the training path's attention takes, on either device (the
    plain backward is written for it too): whole sequences, causal
    self-attention or every query over every key (any Sq, Sk); on the
    card also (D, Dv) in ``FLASH_BWD_DIMS`` (``FLASH_BWD_NONCAUSAL_DIMS``
    when not causal).  Each message names the ROADMAP.md item that lifts
    the limit."""
    name = "flash_prefill_bwd"
    D, Dv = q.shape[-1], v.shape[-1]
    if causal and (int(q_offset) != 0 or q.shape[1] != k.shape[1]):
        raise NotImplementedError(
            f"{name}: whole sequences only (q_offset {int(q_offset)}, Sq "
            f"{q.shape[1]}, Sk {k.shape[1]}); a backward over earlier "
            f"chunks' keys is ROADMAP.md queue 1 item 7, training step 5")
    if not _all_cpu(q, k, v) and (D, Dv) not in _bwd_dims(causal):
        raise NotImplementedError(
            f"{name}: (D, Dv) in {_bwd_dims(causal)} on the card "
            f"{'causal' if causal else 'non-causal'} (got {(D, Dv)}); no "
            f"config of the registry trains other heads")


def _train_modes(D: int, Dv: int, causal: bool, prefix: str = ""
                 ) -> Tuple[str, ...]:
    """The launch counter's labels of a training instance beside its
    kernel's name: MLA's heads, kimi-k2's (112, 112), the non-causal
    mode."""
    heads = {(96, 64): "mla", (112, 112): "d112"}.get((D, Dv))
    return (((prefix + heads,) if heads else ())
            + ((prefix + "noncausal",) if not causal else ()))


def flash_prefill_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training's forward over whole sequences: q (B, Sq, Hq, D), k (B,
    Sk, Hkv, D), v (B, Sk, Hkv, Dv) -> (out (B, Sq, Hq, Dv) in q's dtype,
    lse (B, Hq, Sq) float32, each row's log-sum-exp, natural log).
    Causal self-attention (Sq == Sk), or every query over every key.  On
    the GPU the ``flash_prefill`` kernel with its lse output (bfloat16,
    (D, Dv) in ``FLASH_BWD_DIMS``); a launch also counts under
    "flash_prefill:lse" and, for MLA's heads, kimi-k2's and the
    non-causal mode, under "flash_prefill:lse_mla",
    "flash_prefill:lse_d112" and "flash_prefill:lse_noncausal"."""
    if _all_cpu(q, k, v):
        return ref.flash_prefill_fwd_lse(q, k, v, scale=scale, causal=causal)
    name = "flash_prefill"
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    _check_flash(name, q, k, v, 0)
    _check((not causal or Sk == Sq) and (D, Dv) in _bwd_dims(causal),
           f"{name}: the lse output takes Sq == Sk when causal and (D, Dv) "
           f"in {_bwd_dims(causal)}")
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
                       Dv, 0, int(causal), float(scale), _stream())
    _raise_on(rc, name)
    launches.add(name, "lse", *_train_modes(D, Dv, causal, "lse_"))
    return out, lse


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, scale: float, causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_prefill_fwd_lse`` (``ref.flash_prefill_bwd``):
    q (B, Sq, Hq, D), o, do (B, Sq, Hq, Dv), k (B, Sk, Hkv, D), v (B, Sk,
    Hkv, Dv), lse (B, Hq, Sq) -> (dq, dk, dv) float32, dk and dv summed
    over each GQA group; causal (Sq == Sk) or every query over every key.
    On the GPU: the kernels of ``csrc/flash_prefill_bwd.cu`` (Delta, dK
    and dV a CTA per query head of each group, dQ, and the heads' shares
    of dK and dV summed in head order where G > 1: one count a call, also
    under "flash_prefill_bwd:mla", "flash_prefill_bwd:d112" and
    "flash_prefill_bwd:noncausal" for those instances), bfloat16 q, k,
    v, o, do, (D, Dv) in
    ``FLASH_BWD_DIMS`` (``FLASH_BWD_NONCAUSAL_DIMS`` when not causal);
    deterministic."""
    if _all_cpu(q, k, v, o, lse, do):
        return ref.flash_prefill_bwd(q, k, v, o, lse, do, scale, causal)
    name = "flash_prefill_bwd"
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    _check_cuda(name, q.device, q=q, k=k, v=v, o=o, lse=lse, do=do)
    _check(q.dtype == k.dtype == v.dtype == o.dtype == do.dtype
           == torch.bfloat16 and lse.dtype == torch.float32,
           f"{name}: bfloat16 q, k, v, o, do and float32 lse")
    _check(k.shape == (B, Sk, Hkv, D) and Hkv > 0 and Hq % Hkv == 0
           and (D, Dv) in _bwd_dims(causal) and (not causal or Sq == Sk)
           and o.shape == do.shape == (B, Sq, Hq, Dv)
           and lse.shape == (B, Hq, Sq),
           f"{name}: needs q (B, Sq, Hq, D), o, do (B, Sq, Hq, Dv), k (B, "
           f"Sk, Hkv, D), v (B, Sk, Hkv, Dv), lse (B, Hq, Sq), Hq % Hkv "
           f"== 0, Sq == Sk when causal, (D, Dv) in {_bwd_dims(causal)}")
    _check(_aligned(q, k, v, o, do), f"{name}: 16-byte alignment")
    ws_n = LIBS.fn("flash_prefill_bwd_ws")(B, Sq, Sk, Hq, Hkv, D, Dv)
    ws = torch.empty(ws_n, dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       ws.data_ptr(), ws_n, dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), B, Sq, Sk, Hq, Hkv, D, Dv, int(causal),
                       float(scale), _stream())
    _raise_on(rc, name)
    launches.add(name, *_train_modes(D, Dv, causal))
    return dq, dk, dv


class FlashPrefillFn(torch.autograd.Function):
    """Attention over whole sequences with a gradient:
    ``flash_prefill_fwd_lse`` forward, ``flash_prefill_bwd`` backward,
    causal or not.  On the GPU both run in bfloat16 (float32 q, k, v are
    cast; the output is cast back to q's dtype, the gradients to each
    input's); on the CPU both are the plain versions, in the inputs'
    dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.scale, ctx.causal = scale, causal
        if not _all_cpu(q, k, v):
            q, k, v = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
        o, lse = flash_prefill_fwd_lse(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        return o.to(ctx.dtypes[0])

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type != "cpu":
            do = do.to(torch.bfloat16).contiguous()
        grads = flash_prefill_bwd(q, k, v, o, lse, do, scale=ctx.scale,
                                  causal=ctx.causal)
        return (tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes))
                + (None, None))


# ---------------------------------------------------------------------------
# quantize_blocks / dequantize_blocks / dequantize_scatter_blocks
# ---------------------------------------------------------------------------

def _check_quant(name: str, q: torch.Tensor, scales: torch.Tensor) -> None:
    H, K, bs, D = q.shape
    _check_cuda(name, q.device, q=q, scales=scales)
    _check(q.dtype == torch.int8 and scales.dtype == torch.float32
           and scales.shape == (H, K),
           f"{name}: q int8 (H, K, bs, D), scales float32 (H, K)")
    _check((bs * D) % 4 == 0 and _aligned(q, scales),
           f"{name}: bs * D a multiple of 4, 16-byte alignment")


def quantize_blocks(blocks: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """blocks (H, K, bs, D) float32 or bfloat16 -> (q (H, K, bs, D) int8,
    scales (H, K) float32): symmetric int8 per (head, block), bit for bit
    the plain version's."""
    if _all_cpu(blocks):
        return ref.quantize_blocks(blocks)
    name = "quantize_blocks"
    H, K, bs, D = blocks.shape
    _check_cuda(name, blocks.device, blocks=blocks)
    _check(blocks.dtype in _PAYLOAD_CODES,
           f"{name}: blocks must be float32 or bfloat16")
    _check((bs * D) % 4 == 0 and _aligned(blocks),
           f"{name}: bs * D a multiple of 4, 16-byte alignment")
    q = torch.empty((H, K, bs, D), dtype=torch.int8, device=blocks.device)
    scales = torch.empty((H, K), dtype=torch.float32, device=blocks.device)
    rc = LIBS.fn(name)(_PAYLOAD_CODES[blocks.dtype], blocks.data_ptr(),
                       q.data_ptr(), scales.data_ptr(), H * K, bs * D,
                       _stream())
    _raise_on(rc, name)
    launches.add(name)
    return q, scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor
                      ) -> torch.Tensor:
    """q (H, K, bs, D) int8, scales (H, K) float32 -> (H, K, bs, D)
    float32."""
    if _all_cpu(q, scales):
        return ref.dequantize_blocks(q, scales)
    name = "dequantize_blocks"
    _check_quant(name, q, scales)
    H, K, bs, D = q.shape
    out = torch.empty((H, K, bs, D), dtype=torch.float32, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                       H * K, bs * D, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


def dequantize_scatter_blocks(pool: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor, dest_blocks: torch.Tensor,
                              rows: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Dequantize q (H, K, bs, D) int8 with scales (H, K) and scatter it
    into ``pool`` IN PLACE (the int8 tier's restore into the decode
    slots): pool (H, NB, bs, D) with rows None, or (B, H, NB, bs, D) with
    rows (K,) int32.  Returns ``pool``.  On the GPU the pool is
    bfloat16."""
    if _all_cpu(pool, q, scales, dest_blocks, rows):
        return ref.dequantize_scatter_blocks(pool, q, scales, dest_blocks,
                                             rows)
    name = "dequantize_scatter_blocks"
    _check_quant(name, q, scales)
    if rows is None:
        H, NB, bs, D = pool.shape
        B, row_stride = 1, 0
        head_stride, block_stride = pool.stride(0), pool.stride(1)
    else:
        B, H, NB, bs, D = pool.shape
        row_stride, head_stride, block_stride = pool.stride()[:3]
        _check_cuda(name, q.device, rows=rows)
        _check(rows.dtype == torch.int32, f"{name}: rows must be int32")
    K = dest_blocks.shape[0]
    _check(pool.device == q.device and dest_blocks.device == q.device,
           f"{name}: pool and ids on {q.device}")
    _check(pool.dtype == torch.bfloat16 and dest_blocks.dtype == torch.int32,
           f"{name}: bfloat16 pool, int32 ids")
    _check(pool.stride(-1) == 1 and pool.stride(-2) == D
           and block_stride % 4 == 0 and pool.data_ptr() % 8 == 0,
           f"{name}: each pool block must be contiguous and 8-byte aligned")
    _check(q.shape == (H, K, bs, D) and (rows is None or rows.shape == (K,)),
           f"{name}: q must be (H, K, bs, D) = {(H, K, bs, D)}")
    rc = LIBS.fn(name)(
        q.data_ptr(), scales.data_ptr(),
        None if rows is None else rows.data_ptr(), dest_blocks.data_ptr(),
        pool.data_ptr(), row_stride, head_stride, block_stride, B, H, NB, K,
        bs * D, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return pool


# ---------------------------------------------------------------------------
# quant_save_blocks: the int8 tier's save, one launch per round
# ---------------------------------------------------------------------------

# the largest block (bs * D elements) quant_save_blocks takes: 12 x 4
# elements a thread of 256 (MLA's one latent head of 288: 32 x 288 = 9216)
SAVE_MAX_BLOCK_ELEMS = 12 * 4 * 256


class QuantPool:
    """An int8 tier's pool as ``quant_save_blocks`` takes it: ``q`` (L, H,
    NB, bs, D) int8 and its scale plane ``scales`` (L, H, NB) float32,
    checked once, and where both lie in pinned host memory or on one CUDA
    device, the addresses the kernel reaches them at (``mapped``; None for
    pools only the plain version takes), so a call spends nothing on them.
    Build it when the pool is allocated, not per call; it keeps both
    tensors alive.  On the GPU: contiguous, 4-byte aligned, D % 4 == 0
    and bs * D <= ``SAVE_MAX_BLOCK_ELEMS``."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor):
        name = "quant_save_blocks"
        _check(q.dtype == torch.int8 and scales.dtype == torch.float32
               and q.dim() == 5 and scales.shape == q.shape[:3]
               and q.device == scales.device,
               f"{name}: an int8 pool (L, H, NB, bs, D) with its float32 "
               f"scales (L, H, NB) on its device")
        self.q, self.scales = q, scales
        self.mapped: Optional[Tuple[int, int]] = None
        on_host = q.device.type == "cpu"
        if on_host and not (q.is_pinned() and scales.is_pinned()):
            return
        _, _, _, bs, D = q.shape
        _check(D % 4 == 0 and bs * D <= SAVE_MAX_BLOCK_ELEMS
               and q.is_contiguous() and scales.is_contiguous()
               and q.data_ptr() % 4 == 0 and scales.data_ptr() % 4 == 0,
               f"{name}: contiguous, 4-byte aligned pools with D % 4 == 0 "
               f"and bs * D <= {SAVE_MAX_BLOCK_ELEMS}")
        self.mapped = (_device_address(q, on_host),
                       _device_address(scales, on_host))


class QuantSave(NamedTuple):
    """One staged stripe of the int8 tier's save: ``stripe`` (H, T, D),
    float32 or bfloat16, lands at tokens [start, start + T) of layer
    ``layer`` of ``pool``."""
    pool: QuantPool
    layer: int
    start: int
    stripe: torch.Tensor


def _device_address(t: torch.Tensor, on_host: bool) -> int:
    """Where a kernel reaches ``t``'s first element: its data pointer, or
    for a pinned host tensor the device-mapped address of its allocation
    plus its offset there."""
    if not on_host:
        return t.data_ptr()
    base = t.untyped_storage().data_ptr()
    out = ctypes.c_void_p()
    _raise_on(LIBS.fn("host_device_address")(base, ctypes.addressof(out)),
              "host_device_address")
    return out.value + t.data_ptr() - base


def pack_save_items(cols, bs: int, D: int) -> Tuple[np.ndarray, list]:
    """The kernel's items (``SaveItem`` in ``csrc/quant_blocks.cu``, 8
    int64 each), one per block segment of every stripe, ordered by round,
    and the number of items of each round.  ``cols``: per stripe, in
    staging order, (stripe address, head and token strides in elements,
    element size, address of its pool's layer, NB, address of its scale
    plane's layer, dtype code, start token, T >= 1).  An item's round is
    the number of earlier items on the same pool block, so no round
    writes a block twice and a block's segments run in staging order."""
    c = np.array(cols, np.int64)
    start = c[:, 8]
    nseg = (start + c[:, 9] - 1) // bs - start // bs + 1
    r = np.repeat(c, nseg, axis=0)
    start = r[:, 8]
    blk = start // bs + np.arange(len(r)) - np.repeat(np.cumsum(nseg) - nseg,
                                                       nseg)
    t0 = np.maximum(blk * bs - start, 0)
    n = np.minimum((blk + 1) * bs - start, r[:, 9]) - t0
    items = np.empty((len(r), 8), np.int64)
    items[:, 0] = r[:, 0] + t0 * r[:, 2] * r[:, 3]
    items[:, 1:3] = r[:, 1:3]
    items[:, 3] = r[:, 4] + blk * (bs * D)
    items[:, 4] = r[:, 5] * (bs * D)
    items[:, 5] = r[:, 6] + blk * 4
    items[:, 6] = r[:, 5]
    items[:, 7] = (start + t0 - blk * bs) | n << 16 | r[:, 7] << 32
    dest = items[:, 3]
    if len(set(dest.tolist())) == len(dest):
        return items, [len(dest)]
    order = np.argsort(dest, kind="stable")
    new = np.r_[True, dest[order][1:] != dest[order][:-1]]
    idx = np.arange(len(dest))
    rounds = np.empty_like(dest)
    rounds[order] = idx - np.maximum.accumulate(np.where(new, idx, 0))
    return (items[np.argsort(rounds, kind="stable")],
            np.bincount(rounds).tolist())


def quant_save_blocks(saves: Sequence[QuantSave]) -> int:
    """The int8 tier's save, IN PLACE: for every block segment of every
    stripe, in the order given, the resident block of every head is
    dequantized with its scale, the stripe's tokens overwrite their slots
    (widened to float32), and the block is requantized with a fresh
    per-head scale (``quantize_blocks``' arithmetic) and written back with
    it.  Returns the block segments written.

    Block ids are checked on the host, on both paths (IndexError on a
    stripe past its pool or a layer out of range, before anything is
    written).  On the GPU every stripe is a CUDA tensor (any head and
    token strides, unit element stride) and every pool (a ``QuantPool``
    with ``mapped`` addresses) lies on that device or in pinned host
    memory, read and written in place; all pools share H, bs and D.  The
    segments are cut, in the order given, into rounds in which
    no block of a pool appears twice (a second requantize of a block is not
    one merged requantize): one upload of the items, one launch per round.
    """
    name = "quant_save_blocks"
    written = 0
    for sv in saves:
        L, _, NB, bs, _ = sv.pool.q.shape
        T = sv.stripe.shape[1]
        if not 0 <= sv.layer < L:
            raise IndexError(f"{name}: layer {sv.layer} out of range "
                             f"[0, {L})")
        if T and (sv.start < 0 or (sv.start + T - 1) // bs >= NB):
            raise IndexError(f"{name}: tokens [{sv.start}, {sv.start + T}) "
                             f"leave the pool's {NB} blocks of {bs}")
        if T:
            written += (sv.start + T - 1) // bs - sv.start // bs + 1
    if _all_cpu(*(t for sv in saves
                  for t in (sv.pool.q, sv.pool.scales, sv.stripe))):
        ref.quant_save_blocks(saves)
        return written
    saves = [sv for sv in saves if sv.stripe.shape[1]]
    if not saves:
        return written
    dev = saves[0].stripe.device
    _check(dev.type == "cuda", f"{name}: stripes on {dev} for pools on the "
                               f"GPU or in pinned memory")
    _, H, _, bs, D = saves[0].pool.q.shape
    cols = []
    for qp, layer, start, stripe in saves:
        L, Hp, NB, bsp, Dp = qp.q.shape
        _check(qp.mapped is not None
               and (qp.q.device.type == "cpu" or qp.q.device == dev),
               f"{name}: a pool on {qp.q.device} (pinned host memory or "
               f"{dev} taken) for stripes on {dev}")
        _check((Hp, bsp, Dp) == (H, bs, D)
               and stripe.device == dev and stripe.dtype in _PAYLOAD_CODES
               and stripe.shape[0] == H and stripe.shape[2] == D
               and stripe.stride(2) == 1,
               f"{name}: pools of one H, bs and D; float32 or bfloat16 "
               f"stripes (H, T, D) on {dev} with unit element stride")
        lo = layer * H * NB
        cols.append((stripe.data_ptr(), stripe.stride(0), stripe.stride(1),
                     stripe.element_size(), qp.mapped[0] + lo * bs * D, NB,
                     qp.mapped[1] + lo * 4, _PAYLOAD_CODES[stripe.dtype],
                     start, stripe.shape[1]))
    items, sizes = pack_save_items(cols, bs, D)
    # the kernel writes the pools in place, and PyTorch's caching host
    # allocator does not track a pinned pool's use by a kernel: the caller
    # keeps every pool alive until the stream has passed these launches
    # (the engine reads each step's logits back, a stream sync, before
    # any release drops a request's pools)
    dev_items = host_to_device(items, dev, torch.int64)
    fn = LIBS.fn(name)
    at = dev_items.data_ptr()
    for size in sizes:
        _raise_on(fn(at, size, H, bs, D, _stream()), name)
        launches.add(name)
        at += size * items.shape[1] * 8
    return written


# ---------------------------------------------------------------------------
# selective_scan: the Mamba layer's SSM recurrence
# ---------------------------------------------------------------------------

# tokens the kernel stages in shared memory per pass (csrc/selective_scan.cu
# kChunk; also the training forward's checkpoint interval, which the
# backward reruns), the one state width it takes, and the multiple of 8
# channels d_inner must be (its 16-byte copies of bf16 x)
SCAN_CHUNK, SCAN_STATES, SCAN_CHANNEL_MULTIPLE = 64, 16, 8


def selective_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan over a whole window (S = 1 is the decode
    step): x, dt (Bt, S, di); B, C (Bt, S, ds); A (di, ds), already
    -exp(A_log); D (di,); h0 (Bt, di, ds) -> (y (Bt, S, di) float32, h
    after token S-1 (Bt, di, ds) float32); see ``ref.selective_scan``.
    On the GPU: x, B and C bfloat16 (as the Mamba layer passes them), dt,
    A, D and h0 float32, ds = 16, di a multiple of 8, all contiguous."""
    if _all_cpu(x, dt, B, C, A, D, h0):
        return ref.selective_scan(x, dt, B, C, A, D, h0)
    name = "selective_scan"
    Bt, S, di = x.shape
    ds = B.shape[-1]
    _check_cuda(name, x.device, x=x, dt=dt, B=B, C=C, A=A, D=D, h0=h0)
    _check(x.dtype == B.dtype == C.dtype == torch.bfloat16
           and dt.dtype == A.dtype == D.dtype == h0.dtype == torch.float32,
           f"{name}: x, B and C bfloat16; dt, A, D and h0 float32")
    _check(dt.shape == x.shape and B.shape == C.shape == (Bt, S, ds)
           and A.shape == (di, ds) and D.shape == (di,)
           and h0.shape == (Bt, di, ds) and ds == SCAN_STATES,
           f"{name}: needs dt (Bt, S, di), B and C (Bt, S, {SCAN_STATES}), "
           f"A (di, {SCAN_STATES}), D (di,), h0 (Bt, di, {SCAN_STATES})")
    _check(di % SCAN_CHANNEL_MULTIPLE == 0,
           f"{name}: d_inner must be a multiple of {SCAN_CHANNEL_MULTIPLE} "
           f"(di = {di})")
    _check(_aligned(x, dt, B, C, A, h0),
           f"{name}: x, dt, B, C, A and h0 must be 16-byte aligned")
    y = torch.empty((Bt, S, di), dtype=torch.float32, device=x.device)
    h = torch.empty((Bt, di, ds), dtype=torch.float32, device=x.device)
    rc = LIBS.fn(name)(x.data_ptr(), dt.data_ptr(), B.data_ptr(),
                       C.data_ptr(), A.data_ptr(), D.data_ptr(),
                       h0.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, S, di,
                       ds, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return y, h


def _check_scan_f32(name: str, x: torch.Tensor, dt: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
                    D: torch.Tensor, h: torch.Tensor, **more) -> None:
    """Checks of the training kernels' operands: every one float32 (the
    training precision), contiguous and 16-byte aligned on x's device;
    x, dt (and ``more``'s dy) (Bt, S, di) with S > 0, B, C (Bt, S, 16), A
    (di, 16), D (di,), the state ``h`` (Bt, ..., di, 16); di a multiple
    of 8."""
    Bt, S, di = x.shape
    _check_cuda(name, x.device, x=x, dt=dt, B=B, C=C, A=A, D=D, h=h, **more)
    _check(all(t.dtype == torch.float32
               for t in (x, dt, B, C, A, D, h, *more.values())),
           f"{name}: every operand float32 (the training precision)")
    _check(S > 0 and dt.shape == x.shape
           and B.shape == C.shape == (Bt, S, SCAN_STATES)
           and A.shape == (di, SCAN_STATES) and D.shape == (di,)
           and h.shape[0] == Bt and h.shape[-2:] == (di, SCAN_STATES)
           and Bt <= 65535,
           f"{name}: needs x, dt (Bt, S, di) with S > 0 and Bt <= 65535, B "
           f"and C (Bt, S, {SCAN_STATES}), A (di, {SCAN_STATES}), D (di,), "
           f"states (Bt, ..., di, {SCAN_STATES})")
    _check(di % SCAN_CHANNEL_MULTIPLE == 0,
           f"{name}: d_inner must be a multiple of {SCAN_CHANNEL_MULTIPLE} "
           f"(di = {di})")
    _check(_aligned(x, dt, B, C, A, D, h, *more.values()),
           f"{name}: 16-byte alignment")


def selective_scan_train(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                         h0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training's forward of the selective scan: ``selective_scan``'s
    function on float32 x, B and C (the reference's training precision)
    -> (y, the final state, h_ckpt (Bt, ceil(S / SCAN_CHUNK), di, 16):
    the state before each SCAN_CHUNK-token chunk, which
    ``selective_scan_bwd`` reruns the chunks from; h0 itself, as one
    chunk, on the CPU).  On the GPU ``launch_selective_scan_f32``
    (csrc/selective_scan.cu, kernel C), every operand float32, ds = 16,
    di a multiple of 8; a call counts under "selective_scan" and
    "selective_scan:train"."""
    if _all_cpu(x, dt, B, C, A, D, h0):
        y, h = ref.selective_scan(x, dt, B, C, A, D, h0)
        return y, h, h0[:, None]
    name = "selective_scan"
    _check_scan_f32(name, x, dt, B, C, A, D, h0)
    Bt, S, di = x.shape
    _check(h0.shape == (Bt, di, SCAN_STATES),
           f"{name}: h0 (Bt, di, {SCAN_STATES})")
    dev = x.device
    y = torch.empty((Bt, S, di), dtype=torch.float32, device=dev)
    h = torch.empty((Bt, di, SCAN_STATES), dtype=torch.float32, device=dev)
    ckpt = torch.empty((Bt, -(-S // SCAN_CHUNK), di, SCAN_STATES),
                       dtype=torch.float32, device=dev)
    rc = LIBS.fn("selective_scan:train")(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), ckpt.data_ptr(), Bt, S, di, SCAN_STATES, _stream())
    _raise_on(rc, name)
    launches.add(name, "train")
    return y, h, ckpt


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       h_ckpt: torch.Tensor, dy: torch.Tensor,
                       dh: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan_train`` (``ref.selective_scan_bwd``):
    x, dt, dy (Bt, S, di); B, C (Bt, S, 16); A (di, 16); D (di,); h_ckpt
    from ``selective_scan_train``; dh the final state's gradient (Bt, di,
    16) -> (dx, ddt, dB, dC, dA, dD, dh0), float32.  On the GPU the
    kernels of csrc/selective_scan_bwd.cu (kernel D: the forward's chunks
    in reverse, each rerun from its checkpoint, then the sums over
    channels and rows in a fixed order: deterministic), every operand
    float32, h_ckpt with the forward's chunk count; a call counts one
    launch.  A CUDA tensor it cannot take raises, naming the limit."""
    if _all_cpu(x, dt, B, C, A, D, h_ckpt, dy, dh):
        return ref.selective_scan_bwd(x, dt, B, C, A, D, h_ckpt[:, 0], dy,
                                      dh)
    name = "selective_scan_bwd"
    _check_scan_f32(name, x, dt, B, C, A, D, h_ckpt, dy=dy, dh=dh)
    Bt, S, di = x.shape
    n_ck = -(-S // SCAN_CHUNK)
    _check(dy.shape == x.shape and dh.shape == (Bt, di, SCAN_STATES)
           and h_ckpt.shape == (Bt, n_ck, di, SCAN_STATES),
           f"{name}: dy (Bt, S, di), dh (Bt, di, {SCAN_STATES}), h_ckpt "
           f"(Bt, {n_ck}, di, {SCAN_STATES}), the forward's chunks of "
           f"{SCAN_CHUNK} (got {tuple(h_ckpt.shape)})")
    dev = x.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dx, ddt = new(Bt, S, di), new(Bt, S, di)
    dB, dC = new(Bt, S, SCAN_STATES), new(Bt, S, SCAN_STATES)
    dA, dD, dh0 = new(di, SCAN_STATES), new(di), new(Bt, di, SCAN_STATES)
    ws_n = LIBS.fn("selective_scan_bwd_ws")(Bt, S, di)
    ws = new(ws_n)
    rc = LIBS.fn(name)(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), h_ckpt.data_ptr(), dy.data_ptr(),
        dh.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
        ws.data_ptr(), ws_n, Bt, S, di, SCAN_STATES, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return dx, ddt, dB, dC, dA, dD, dh0


class SelectiveScanFn(torch.autograd.Function):
    """The selective scan with a gradient, for training: (x, dt (Bt, S,
    di), B, C (Bt, S, 16), A (di, 16), D (di,), h0 (Bt, di, 16)) -> (y,
    the final state), ``selective_scan``'s function.  Forward
    ``selective_scan_train`` (kernel C), backward ``selective_scan_bwd``
    (kernel D).  Every operand runs in float32 (others are cast, the
    gradients cast back to each input's dtype); on the CPU both are the
    plain versions."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, D, h0):
        ctx.dtypes = tuple(t.dtype for t in (x, dt, B, C, A, D, h0))
        x, dt, B, C, A, D, h0 = (t.float().contiguous()
                                 for t in (x, dt, B, C, A, D, h0))
        y, h, ckpt = selective_scan_train(x, dt, B, C, A, D, h0)
        ctx.save_for_backward(x, dt, B, C, A, D, ckpt)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, B, C, A, D, ckpt = ctx.saved_tensors
        grads = selective_scan_bwd(x, dt, B, C, A, D, ckpt,
                                   dy.float().contiguous(),
                                   dh.float().contiguous())
        return tuple(g.to(t) for g, t in zip(grads, ctx.dtypes))


# ---------------------------------------------------------------------------
# wkv6: the RWKV6 time-mix's WKV recurrence
# ---------------------------------------------------------------------------

# the one head width the kernel takes (csrc/wkv6.cu kHead: each thread keeps
# whole state columns), the tokens it stages per pass (kStage: a chunk is a
# multiple), the shortest chunk it cuts a window into, and the CTAs an SM
# it aims the chunked grid at (wkv6_chunk)
WKV_HEAD, WKV_STAGE = 64, 16
WKV_MIN_CHUNK, WKV_CTAS_PER_SM = 64, 8


def wkv6_chunk(Bt: int, S: int, H: int, sms: int) -> int:
    """The chunk length L that ``wkv6``'s kernel cuts a window of S tokens
    into, so that B * H * ceil(S / L) CTAs give about WKV_CTAS_PER_SM an
    SM on a card of ``sms`` SMs: at least WKV_MIN_CHUNK tokens and a
    multiple of WKV_STAGE (512 at B 1, S 16,384, H 32 on 132 SMs).  A
    window of at most one chunk, the decode step among them, runs in one
    pass: then L >= S."""
    want = max(1, -(-WKV_CTAS_PER_SM * sms // max(1, Bt * H)))
    L = max(WKV_MIN_CHUNK, -(-S // want))
    return -(-L // WKV_STAGE) * WKV_STAGE


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6's WKV recurrence over a whole window (S = 1 is the decode
    step): r, k, v, w (B, S, H, hd); u (H, hd); S0 (B, H, hd, hd) -> (y
    (B, S, H, hd) float32, the state after token S-1 (B, H, hd, hd)
    float32); see ``ref.wkv6``.  On the GPU: r, k and v bfloat16, w, u
    and S0 float32, hd = 64, all contiguous.  A window longer than
    ``wkv6_chunk``'s L runs in time chunks (csrc/wkv6.cu), with scratch
    for each chunk's state allocated here; one call counts one launch."""
    if _all_cpu(r, k, v, w, u, S0):
        return ref.wkv6(r, k, v, w, u, S0)
    name = "wkv6"
    Bt, S, H, hd = r.shape
    _check_cuda(name, r.device, r=r, k=k, v=v, w=w, u=u, S0=S0)
    _check(r.dtype == k.dtype == v.dtype == torch.bfloat16
           and w.dtype == u.dtype == S0.dtype == torch.float32,
           f"{name}: r, k and v bfloat16; w, u and S0 float32")
    _check(hd == WKV_HEAD, f"{name}: the kernel takes head width "
                           f"{WKV_HEAD} only (hd = {hd})")
    _check(k.shape == v.shape == w.shape == r.shape
           and u.shape == (H, hd) and S0.shape == (Bt, H, hd, hd),
           f"{name}: needs r, k, v, w (B, S, H, {hd}), u (H, {hd}), S0 "
           f"(B, H, {hd}, {hd})")
    _check(_aligned(r, k, v, w), f"{name}: r, k, v and w must be 16-byte "
                                 f"aligned")
    dev = r.device
    y = torch.empty((Bt, S, H, hd), dtype=torch.float32, device=dev)
    S_out = torch.empty((Bt, H, hd, hd), dtype=torch.float32, device=dev)
    L = wkv6_chunk(Bt, S, H, _sm_count(dev))
    scratch = wprod = None
    if S > L:
        nc = -(-S // L)
        scratch = torch.empty((Bt, H, nc, hd, hd), dtype=torch.float32,
                              device=dev)
        wprod = torch.empty((Bt, H, nc, hd), dtype=torch.float32,
                            device=dev)
    rc = LIBS.fn(name)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(), S0.data_ptr(),
                       y.data_ptr(), S_out.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       None if wprod is None else wprod.data_ptr(),
                       Bt, S, H, hd, L, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return y, S_out


def _wkv_chunks(name: str, r: torch.Tensor, u: torch.Tensor,
                S0: torch.Tensor, *more: torch.Tensor) -> Tuple[int, int]:
    """Checks of the training kernels' float32 operands (r, k, v, w[, dy]
    in ``more`` beside r, u, the state) -> (L, nc): ``wkv6_chunk``'s
    chunk length and the window's chunk count (1 when S <= L)."""
    Bt, S, H, hd = r.shape
    _check_cuda(name, r.device, r=r, u=u, S0=S0,
                **{f"operand{i}": t for i, t in enumerate(more)})
    _check(all(t.dtype == torch.float32 for t in (r, u, S0) + more),
           f"{name}: every operand float32 (the training precision)")
    _check(hd == WKV_HEAD, f"{name}: the kernel takes head width "
                           f"{WKV_HEAD} only (hd = {hd})")
    _check(S > 0 and all(t.shape == r.shape for t in more)
           and u.shape == (H, hd) and S0.shape[:2] == (Bt, H)
           and S0.shape[-2:] == (hd, hd) and 2 * Bt <= 65535,
           f"{name}: needs r, k, v, w (B, S, H, {hd}) with S > 0 and "
           f"B <= 32767, u (H, {hd}), states (B, H, ..., {hd}, {hd})")
    _check(_aligned(r, u, S0, *more), f"{name}: 16-byte alignment")
    L = wkv6_chunk(Bt, S, H, _sm_count(r.device))
    return L, (-(-S // L) if S > L else 1)


def wkv6_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training's forward of the WKV recurrence: ``wkv6``'s function on
    float32 r, k, v (the reference's training precision) -> (y, the final
    state, S_in (B, H, nc, hd, hd): the state before each of the kernel's
    time chunks, which ``wkv6_bwd`` reruns them from; S0 itself, as one
    chunk, on the CPU or for a window of one chunk).  On the GPU
    ``launch_wkv6_f32`` (csrc/wkv6.cu, kernel A), every operand float32,
    hd = 64; a call counts under "wkv6" and "wkv6:train"."""
    if _all_cpu(r, k, v, w, u, S0):
        y, S_fin = ref.wkv6(r, k, v, w, u, S0)
        return y, S_fin, S0[:, :, None]
    name = "wkv6"
    Bt, S, H, hd = r.shape
    L, nc = _wkv_chunks(name, r, u, S0, k, v, w)
    _check(S0.shape == (Bt, H, hd, hd), f"{name}: S0 (B, H, {hd}, {hd})")
    dev = r.device
    y = torch.empty((Bt, S, H, hd), dtype=torch.float32, device=dev)
    S_out = torch.empty((Bt, H, hd, hd), dtype=torch.float32, device=dev)
    S_in, wprod = S0[:, :, None], None
    if nc > 1:
        S_in = torch.empty((Bt, H, nc, hd, hd), dtype=torch.float32,
                           device=dev)
        wprod = torch.empty((Bt, H, nc, hd), dtype=torch.float32, device=dev)
    rc = LIBS.fn("wkv6:train")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        S0.data_ptr(), y.data_ptr(), S_out.data_ptr(),
        S_in.data_ptr() if nc > 1 else None,
        None if wprod is None else wprod.data_ptr(), Bt, S, H, hd, L,
        _stream())
    _raise_on(rc, name)
    launches.add(name, "train")
    return y, S_out, S_in


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, S_in: torch.Tensor,
             dy: torch.Tensor, dS: torch.Tensor
             ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6_train`` (``ref.wkv6_bwd``): r, k, v, w, dy
    (B, S, H, hd); u (H, hd); S_in from ``wkv6_train``; dS the final
    state's gradient (B, H, hd, hd) -> (dr, dk, dv, dlogw (the gradient
    of log w), du, dS0), float32.  On the GPU the kernels of
    csrc/wkv6_bwd.cu (kernel B: the forward's time chunks in reverse, du
    summed in a fixed order, deterministic), every operand float32, hd =
    64, S_in with the forward's chunk count; a call counts one launch.
    A CUDA tensor it cannot take raises, naming the limit."""
    if _all_cpu(r, k, v, w, u, S_in, dy, dS):
        return ref.wkv6_bwd(r, k, v, w, u, S_in[:, :, 0], dy, dS)
    name = "wkv6_bwd"
    Bt, S, H, hd = r.shape
    L, nc = _wkv_chunks(name, r, u, dS, k, v, w, dy)
    _check(S_in.device == r.device and S_in.is_contiguous()
           and S_in.dtype == torch.float32 and _aligned(S_in)
           and S_in.shape == (Bt, H, nc, hd, hd)
           and dS.shape == (Bt, H, hd, hd),
           f"{name}: S_in (B, H, {nc}, {hd}, {hd}), the forward's chunks "
           f"at L {L} (got {tuple(S_in.shape)}), dS (B, H, {hd}, {hd})")
    dev = r.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dr, dk, dv, dlogw = (new(Bt, S, H, hd) for _ in range(4))
    du, dS0, dupart = new(H, hd), new(Bt, H, hd, hd), new(Bt, H, nc, hd)
    lam, wprod = ((new(Bt, H, nc, hd, hd), new(Bt, H, nc, hd)) if nc > 1
                  else (None, None))
    rc = LIBS.fn(name)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        S_in.data_ptr(), dy.data_ptr(), dS.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
        dS0.data_ptr(), None if lam is None else lam.data_ptr(),
        None if wprod is None else wprod.data_ptr(), dupart.data_ptr(),
        Bt, S, H, hd, L, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return dr, dk, dv, dlogw, du, dS0


class Wkv6Fn(torch.autograd.Function):
    """The WKV recurrence with a gradient, for training: (r, k, v, log w
    (B, S, H, hd), u (H, hd), S0 (B, H, hd, hd)) -> (y, the final state),
    ``wkv6``'s function with w = exp(log w).  Forward ``wkv6_train``
    (kernel A), backward ``wkv6_bwd`` (kernel B), which returns the
    gradient of log w, so no gradient divides by a w that may underflow.
    Every operand runs in float32 (others are cast, the gradients cast
    back to each input's dtype); on the CPU both are the plain versions.
    """

    @staticmethod
    def forward(ctx, r, k, v, logw, u, S0):
        ctx.dtypes = tuple(t.dtype for t in (r, k, v, logw, u, S0))
        r, k, v, logw, u, S0 = (t.float().contiguous()
                                for t in (r, k, v, logw, u, S0))
        w = torch.exp(logw)
        y, S_fin, S_in = wkv6_train(r, k, v, w, u, S0)
        ctx.save_for_backward(r, k, v, w, u, S_in)
        return y, S_fin

    @staticmethod
    def backward(ctx, dy, dS):
        r, k, v, w, u, S_in = ctx.saved_tensors
        grads = wkv6_bwd(r, k, v, w, u, S_in, dy.float().contiguous(),
                         dS.float().contiguous())
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes))
