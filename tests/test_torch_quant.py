"""The int8 DRAM offload tier of the port against the reference's.

1. The plain versions of the three quant kernels (what the wrappers take
   for CPU tensors, and the yardsticks of the CUDA kernels on the card)
   against the reference's jnp oracles (``repro.kernels.ref``), its numpy
   host-pool twins (``_quantize_block_np`` / ``_dequantize_block_np``)
   and its Pallas kernels in interpret mode, on the same numpy inputs
   made from a seed.  The arithmetic is the same step for step (a float32
   division for the scale and its reciprocal, a float32 multiply,
   round-half-to-even), so every comparison is exact: int8 payloads and
   float32 scales bit for bit.  bf16 inputs are held against the jnp
   oracle and the numpy twin only: the reference's own Pallas kernel
   disagrees with them there (``test_quant_kv.py``).
2. The port's int8 ``HostPool`` against the reference's
   ``HostPool(quant="int8")``: after the same stage/flush sequences their
   int8 pools and scale planes are equal byte for byte, and so are the
   wire sizes and the fused-load accounting of ``KVCacheManager``."""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as jkv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import kv_cache as tkv
from repro_torch.kernels import ops, ref


def _blocks(seed, H, K, bs, D, zero_block=True):
    """Per-(head, block) magnitudes spread over three decades, one exact
    tie at .5 after scaling, and an all-zero block."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((H, K, bs, D)).astype(np.float32)
         * r.uniform(0.01, 10.0, (H, K, 1, 1)).astype(np.float32))
    if zero_block:
        x[H - 1, K // 2] = 0.0
    return x


def _np_twin(x):
    """The reference's numpy host-pool quantizer applied per block."""
    H, K = x.shape[:2]
    q = np.zeros(x.shape, np.int8)
    s = np.zeros((H, K), np.float32)
    for k in range(K):
        q[:, k], s[:, k] = jkv._quantize_block_np(x[:, k])
    return q, s


@pytest.mark.parametrize("H,K,bs,D", [(2, 5, 8, 16), (2, 3, 32, 64),
                                      (8, 2, 32, 128)])
def test_quantize_plain_matches_reference_exactly(H, K, bs, D):
    x = _blocks(H * K + D, H, K, bs, D)
    q, s = ops.quantize_blocks(torch.from_numpy(x))
    jq, js = jref.quantize_blocks(jnp.asarray(x))
    pq, ps = jops.quantize_blocks(jnp.asarray(x))
    nq, ns = _np_twin(x)
    for want_q, want_s in ((jq, js), (nq, ns)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    # the Pallas kernel: the same int8 payload; its scale is amax/127 as
    # XLA compiles it inside the kernel, which on some blocks is the
    # reciprocal multiply (one ulp from its own jnp oracle and the numpy
    # twin, which the port equals bit for bit; first block of the first
    # case here)
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(ps), maxulp=1)
    assert s[H - 1, K // 2] == 0 and not q[H - 1, K // 2].any()
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q.abs().max()) <= 127


def test_quantize_plain_bf16_matches_jnp_and_numpy():
    x32 = _blocks(11, 2, 4, 32, 64)
    xb = torch.from_numpy(x32).bfloat16()
    q, s = ops.quantize_blocks(xb)
    jq, js = jref.quantize_blocks(jnp.asarray(x32).astype(jnp.bfloat16))
    nq, ns = _np_twin(xb.float().numpy())
    for want_q, want_s in ((jq, js), (nq, ns)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_dequantize_plain_matches_reference_exactly():
    x = _blocks(12, 2, 6, 32, 64)
    nq, ns = _np_twin(x)
    got = ops.dequantize_blocks(torch.from_numpy(nq), torch.from_numpy(ns))
    for want in (jref.dequantize_blocks(jnp.asarray(nq), jnp.asarray(ns)),
                 jops.dequantize_blocks(jnp.asarray(nq), jnp.asarray(ns))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in range(6):
        np.testing.assert_array_equal(
            got[:, k].numpy(), jkv._dequantize_block_np(nq[:, k], ns[:, k]))


@pytest.mark.parametrize("pool_dtype", [np.float32, "bfloat16"])
def test_dequantize_scatter_plain_matches_reference_exactly(pool_dtype):
    """Into one row's pool (the Pallas signature), and through ``rows``
    into a batch of rows (the port's restore).  A bf16 pool rounds the
    float32 dequant once, as the reference's cast does."""
    r = np.random.default_rng(13)
    H, K, NB, bs, D, B = 2, 4, 9, 16, 32, 3
    nq, ns = _np_twin(_blocks(13, H, K, bs, D))
    dest = np.asarray([7, 0, 4, 2], np.int32)
    base = r.standard_normal((H, NB, bs, D)).astype(np.float32)
    if pool_dtype == "bfloat16":
        t_pool = torch.from_numpy(base).bfloat16()
        j_pool = jnp.asarray(base).astype(jnp.bfloat16)
    else:
        t_pool, j_pool = torch.from_numpy(base), jnp.asarray(base)
    got = ops.dequantize_scatter_blocks(t_pool.clone(), torch.from_numpy(nq),
                                        torch.from_numpy(ns),
                                        torch.from_numpy(dest))
    wants = [jref.dequantize_scatter_blocks(j_pool, jnp.asarray(nq),
                                            jnp.asarray(ns),
                                            jnp.asarray(dest))]
    if pool_dtype != "bfloat16":
        wants.append(jops.dequantize_scatter_blocks(
            j_pool, jnp.asarray(nq), jnp.asarray(ns), jnp.asarray(dest)))
    for want in wants:
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    batch = t_pool[None].repeat(B, 1, 1, 1, 1)
    rows = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    ops.dequantize_scatter_blocks(batch, torch.from_numpy(nq),
                                  torch.from_numpy(ns),
                                  torch.from_numpy(dest), rows)
    for row, blk in zip(rows.tolist(), dest.tolist()):
        assert torch.equal(batch[row, :, blk], got[:, blk])
    assert sum(ops.launches.snapshot().values()) == 0


# ---------------------------------------------------------------------------
# the int8 host pool
# ---------------------------------------------------------------------------

GEOM = dict(num_layers=2, num_kv_heads=2, block_size=8, head_dim=16)
# (layer, start token, tokens): whole-block prefill stripes; a stripe that
# starts mid-block and spans three blocks; single-token decode appends
# that cross a block boundary (tokens 31 -> 32); a stripe into the last
# block of the other layer
SEQUENCES = {
    "prefill_whole_blocks": [(0, 0, 16), (1, 0, 24)],
    "stripe_from_mid_block": [(0, 0, 5), (0, 5, 19), (1, 3, 10)],
    "decode_appends_across_a_block": [(0, 0, 29), (0, 29, 1), (0, 30, 1),
                                      (0, 31, 1), (0, 32, 1), (0, 33, 1),
                                      (1, 0, 40)],
}


def _pools(num_blocks=5):
    jg, tg = jkv.KVGeometry(**GEOM), tkv.KVGeometry(**GEOM)
    return (jkv.HostPool(jg, num_blocks, quant="int8"),
            tkv.HostPool(tg, num_blocks, quant="int8"))


def _assert_same_bytes(jp, tp):
    for a, b in ((jp.k, tp.k), (jp.v, tp.v), (jp.k_scale, tp.k_scale),
                 (jp.v_scale, tp.v_scale)):
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_int8_host_pool_matches_reference_byte_for_byte(name):
    jp, tp = _pools()
    r = np.random.default_rng(len(name))
    for layer, start, T in SEQUENCES[name]:
        # a new magnitude per stripe, so a requantized block's scale moves
        mag = np.float32(r.uniform(0.1, 8.0))
        k = r.standard_normal((2, T, 16)).astype(np.float32) * mag
        v = r.standard_normal((2, T, 16)).astype(np.float32)
        assert tp.stage(layer, start, k, v) == jp.stage(layer, start, k, v)
        assert tp.flush() == jp.flush()
        _assert_same_bytes(jp, tp)
    assert asdict(tp.stats) == asdict(jp.stats) and tp.stats.d2h_blocks > 0
    # the gather returns the stored payload and its scales
    blocks = [3, 0, 1]
    (kq, ks), (vq, vs) = tp.gather(1, blocks)
    jk, jv = jp.gather(1, blocks)
    np.testing.assert_array_equal(ref.dequantize_blocks(kq, ks).numpy(), jk)
    np.testing.assert_array_equal(ref.dequantize_blocks(vq, vs).numpy(), jv)
    assert kq.dtype == torch.int8 and ks.shape == (2, 3)


def test_int8_host_pool_batches_staged_stripes_in_order():
    """Several stripes staged before one flush, two of them into the same
    block, land as the reference's sequential flush lands them."""
    jp, tp = _pools()
    r = np.random.default_rng(9)
    for layer, start, T in ((0, 0, 5), (0, 5, 2), (1, 0, 12), (0, 7, 3)):
        k = r.standard_normal((2, T, 16)).astype(np.float32)
        v = r.standard_normal((2, T, 16)).astype(np.float32) * 3
        assert tp.stage(layer, start, k, v) == jp.stage(layer, start, k, v)
    assert tp.flush() == jp.flush() == 6
    _assert_same_bytes(jp, tp)


def test_int8_wire_bytes_and_fused_accounting_match_reference():
    jg, tg = jkv.KVGeometry(**GEOM), tkv.KVGeometry(**GEOM)
    jm = jkv.KVCacheManager(jg, 1 << 20, offload_quant="int8")
    tm = tkv.KVCacheManager(tg, 1 << 20, offload_quant="int8")
    r = np.random.default_rng(5)
    for m in (jm, tm):
        m.register("a", 40, 4)
        m.register("b", 24, 4)
    for layer in range(2):
        kv = {rid: (0, r.standard_normal((2, T, 16)).astype(np.float32),
                    r.standard_normal((2, T, 16)).astype(np.float32))
              for rid, T in (("a", 35), ("b", 17))}
        for m in (jm, tm):
            m.save_new_tokens_fused(layer, kv)
            for p in m.pools.values():
                p.flush()
    for n in (1, 3):
        assert tm.pools["a"].wire_bytes(n) == jm.pools["a"].wire_bytes(n)
    want = {"a": [4, 1], "b": [2]}
    jout = jm.load_blocks_fused(1, want)
    tout = tm.load_blocks_fused(1, want)
    assert asdict(tm.fused_stats) == asdict(jm.fused_stats)
    assert asdict(tm.total_stats()) == asdict(jm.total_stats())
    for rid in want:
        (kq, ks), (vq, vs) = tout[rid]
        np.testing.assert_array_equal(
            ref.dequantize_blocks(kq, ks).numpy(), jout[rid][0])
        np.testing.assert_array_equal(
            ref.dequantize_blocks(vq, vs).numpy(), jout[rid][1])
    # the stored size: 1 B per element plus a 4-byte scale per (kv-head,
    # block) per tensor, against the fp tier's float32 elements
    fp = tkv.HostPool(tg, 5).wire_bytes(1)
    assert tm.pools["a"].wire_bytes(1) == 2 * 2 * (8 * 16 + 4)
    assert fp == 2 * 2 * 8 * 16 * 4
