"""Wrappers of the port's hand-written Hopper kernels.

Each wrapper decides by the device of the tensors it is given: for CPU
tensors it returns the plain PyTorch version from ``ref.py`` (what the CPU
tests run); for CUDA tensors it checks device, dtype, shape and contiguity
(the kernels take bfloat16 activations and pools, as the serving path
holds them on the GPU, and the int8 tier's int8 payloads with float32
scales),
allocates its output with ``torch.empty``, launches the CUDA kernel on
``torch.cuda.current_stream()`` and raises if the launch returned an error.
There is no fallback from a CUDA tensor to the plain version.

``launches`` counts kernel launches per wrapper (plain-version calls are not
counted), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import LIBS

_PAYLOAD_CODES = {torch.float32: 0, torch.bfloat16: 1}   # common.cuh DType


class LaunchCounter:
    """Kernel launches per wrapper name since the last ``reset``."""

    NAMES = ("sparse_decode_attention", "block_score", "gather_blocks_hkv",
             "scatter_blocks_hkv", "write_blocks_hkv", "flash_prefill",
             "quantize_blocks", "dequantize_blocks",
             "dequantize_scatter_blocks")

    def __init__(self):
        self.counts: Dict[str, int] = dict.fromkeys(self.NAMES, 0)

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.NAMES, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)

    def add(self, name: str) -> None:
        self.counts[name] += 1


launches = LaunchCounter()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
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


# ---------------------------------------------------------------------------
# sparse_decode_attention
# ---------------------------------------------------------------------------

def sparse_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_idx: torch.Tensor,
                            sel_valid: torch.Tensor, cur_len: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); pools (B, Hkv, NB, bs, D|Dv); block_idx int32 and
    sel_valid bool (B, Hkv, K); cur_len int32 (B,) -> (B, Hq, Dv)."""
    if q.device.type == "cpu":
        return ref.sparse_decode_attention(q, k_pool, v_pool, block_idx,
                                           sel_valid, cur_len, scale)
    name = "sparse_decode_attention"
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
    _check(Hq // Hkv <= 16 and D <= 128 and Dv <= 128 and bs <= 128
           and D % vec == 0 and Dv % vec == 0,
           f"{name}: needs G <= 16, D, Dv <= 128 in 16-byte multiples, "
           f"bs <= 128")
    _check(_aligned(q, k_pool, v_pool), f"{name}: 16-byte alignment")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    rc = LIBS.fn(name)(
        q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_idx.data_ptr(), sel_valid.data_ptr(),
        cur_len.data_ptr(), out.data_ptr(), B, Hkv, NB, bs, D, Dv, K,
        Hq // Hkv, float(scale), _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


# ---------------------------------------------------------------------------
# block_score
# ---------------------------------------------------------------------------

def block_score(q: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D); meta (B, Hkv, NB, 2, D) float32, [min, max] interleaved
    -> (B, Hkv, NB) float32 cuboid bounds, max over the GQA group."""
    if q.device.type == "cpu":
        return ref.block_score(q, meta)
    name = "block_score"
    B, Hq, D = q.shape
    _, Hkv, NB, two, Dm = meta.shape
    _check_cuda(name, q.device, q=q, meta=meta)
    _check(q.dtype == torch.bfloat16 and meta.dtype == torch.float32,
           f"{name}: q bfloat16, meta float32")
    _check(meta.shape[0] == B and two == 2 and Dm == D and Hq % Hkv == 0,
           f"{name}: inconsistent shapes")
    _check(D <= 128 and 8 * Hq // Hkv * D <= 48 * 1024,
           f"{name}: needs D <= 128 and G * D * 8 bytes <= 48 KB")
    out = torch.empty((B, Hkv, NB), dtype=torch.float32, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), meta.data_ptr(), out.data_ptr(), B, Hkv,
                       NB, D, Hq // Hkv, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


# ---------------------------------------------------------------------------
# gather_blocks_hkv
# ---------------------------------------------------------------------------

def gather_blocks_hkv(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool (H, NB, bs, D), idx (K,) int32 -> (H, K, bs, D) on idx's device.

    On the GPU the pool may lie in pinned host memory: the kernel then
    reads it in place (FlashH2D), and the result lands in device memory.
    Any element type: blocks move as bytes (whole 4-byte words)."""
    if idx.device.type == "cpu":
        return ref.gather_blocks_hkv(pool, idx)
    name = "gather_blocks_hkv"
    H, NB, bs, D = pool.shape
    K = idx.shape[0]
    on_host = pool.device.type == "cpu"
    if on_host:
        _check(pool.is_pinned(),
               f"{name}: a host pool must be in pinned memory")
    else:
        _check(pool.device == idx.device,
               f"{name}: pool on {pool.device}, idx on {idx.device}")
    _check(pool.is_contiguous() and idx.is_contiguous()
           and idx.dtype == torch.int32 and idx.dim() == 1,
           f"{name}: contiguous pool, 1-D int32 idx")
    block_bytes = bs * D * pool.element_size()
    _check(block_bytes % 4 == 0 and pool.data_ptr() % 4 == 0,
           f"{name}: blocks must be whole 4-byte words")
    out = torch.empty((H, K, bs, D), dtype=pool.dtype, device=idx.device)
    storage = pool.untyped_storage()
    base = storage.data_ptr()
    rc = LIBS.fn("gather_blocks")(
        base, pool.data_ptr() - base, int(on_host), idx.data_ptr(),
        out.data_ptr(), H, NB, K, block_bytes, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


# ---------------------------------------------------------------------------
# scatter_blocks_hkv
# ---------------------------------------------------------------------------

def scatter_blocks_hkv(pool: torch.Tensor, payload: torch.Tensor,
                       dest_blocks: torch.Tensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter payload (H, K, bs, D) into ``pool`` IN PLACE, cast to the
    pool's dtype: pool (H, NB, bs, D) with rows None, or
    (B, H, NB, bs, D) with rows (K,) int32.  Returns ``pool``.

    On the GPU the pool is bfloat16 on the payload's device and the
    payload float32 (a restore from the host pool) or bfloat16 (a drop's
    zero blocks)."""
    if pool.device.type == "cpu" and payload.device.type == "cpu":
        return ref.scatter_blocks_hkv(pool, payload, dest_blocks, rows)
    name = "scatter_blocks_hkv"
    _check(pool.device == payload.device,
           f"{name}: pool on {pool.device}, payload on {payload.device}")
    if rows is None:
        H, NB, bs, D = pool.shape
        B, row_stride = 1, 0
        head_stride, block_stride = pool.stride(0), pool.stride(1)
    else:
        B, H, NB, bs, D = pool.shape
        row_stride, head_stride, block_stride = pool.stride()[:3]
        _check_cuda(name, pool.device, rows=rows)
        _check(rows.dtype == torch.int32, f"{name}: rows must be int32")
    K = dest_blocks.shape[0]
    _check_cuda(name, pool.device, payload=payload, dest_blocks=dest_blocks)
    _check(pool.stride(-1) == 1 and pool.stride(-2) == D,
           f"{name}: each pool block must be contiguous")
    _check(payload.shape == (H, K, bs, D)
           and (rows is None or rows.shape == (K,)),
           f"{name}: payload must be (H, K, bs, D) = {(H, K, bs, D)}")
    _check(pool.dtype == torch.bfloat16 and payload.dtype in _PAYLOAD_CODES
           and dest_blocks.dtype == torch.int32,
           f"{name}: bfloat16 pool, float32/bfloat16 payload, int32 ids")
    rc = LIBS.fn("scatter_blocks")(
        _PAYLOAD_CODES[payload.dtype], payload.data_ptr(),
        None if rows is None else rows.data_ptr(),
        dest_blocks.data_ptr(), pool.data_ptr(), row_stride, head_stride,
        block_stride, B, H, NB, K, bs * D, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return pool


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
    if pool.device.type == "cpu" and payload.device.type == "cpu":
        return ref.write_blocks_hkv(pool, payload, dest_blocks)
    name = "write_blocks_hkv"
    _check(payload.device.type == "cuda",
           f"{name}: payload on {payload.device} for a pool on "
           f"{pool.device}")
    H, NB, bs, D = pool.shape
    K = dest_blocks.shape[0]
    on_host = pool.device.type == "cpu"
    if on_host:
        _check(pool.is_pinned(),
               f"{name}: a host pool must be in pinned memory")
    else:
        _check(pool.device == payload.device,
               f"{name}: pool on {pool.device}, payload on "
               f"{payload.device}")
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
    rc = LIBS.fn("write_blocks")(
        payload.data_ptr(), dest_blocks.data_ptr(), base,
        pool.data_ptr() - base, int(on_host), pool.stride(0) * esz,
        pool.stride(1) * esz, H, NB, K, block_bytes, _stream())
    _raise_on(rc, name)
    launches.add(name)
    return pool


# ---------------------------------------------------------------------------
# flash_prefill
# ---------------------------------------------------------------------------

def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True,
                  q_offset: int = 0) -> torch.Tensor:
    """Causal prefill attention: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D|Dv)
    -> (B, Sq, Hq, Dv) in q's dtype; q_offset is the absolute position of
    q[0] (earlier chunks' keys lie ahead of the window, Sk = q_offset + Sq
    on the serving path).  On the GPU: bfloat16, causal, D = Dv in
    {64, 128}."""
    if q.device.type == "cpu":
        return ref.flash_prefill(q, k, v, scale=scale, causal=causal,
                                 q_offset=q_offset)
    name = "flash_prefill"
    _check(causal, f"{name}: the kernel is causal only (non-causal "
                   f"attention is not ported yet)")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    q_offset = int(q_offset)
    _check_cuda(name, q.device, q=q, k=k, v=v)
    _check(q.dtype == k.dtype == v.dtype == torch.bfloat16,
           f"{name}: q, k and v must be bfloat16")
    _check(k.shape == (B, Sk, Hkv, D) and Hkv > 0 and Hq % Hkv == 0
           and Dv == D and D in (64, 128) and q_offset >= 0,
           f"{name}: needs k/v (B, Sk, Hkv, D), Hq % Hkv == 0, "
           f"D = Dv in (64, 128), q_offset >= 0")
    _check(_aligned(q, k, v), f"{name}: 16-byte alignment")
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    rc = LIBS.fn(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, q_offset,
                       float(scale), _stream())
    _raise_on(rc, name)
    launches.add(name)
    return out


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
    if blocks.device.type == "cpu":
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
    if q.device.type == "cpu":
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
    if q.device.type == "cpu":
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
