"""The port's kernels of slice 1 and the int8 tier's write back: plain
PyTorch versions (what the wrappers take for CPU tensors) held against
the reference's jnp oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode (``repro.kernels.ops``), on the same numpy
inputs made from a seed.

Tolerances: gather and scatter move data only, so they are compared
bit-exactly; block scores and attention accumulate float32 sums in another
order than XLA, so they are compared with atol 1e-5 / rtol 1e-5 at these
sizes (a few hundred terms of O(1) values).

The CUDA kernels themselves run only on the card: see
``test_torch_cuda.py`` (``gpu`` marker) and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as jkv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import kv_cache as tkv
from repro_torch.kernels import ops, ref

ATOL = RTOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_inputs(seed, B, Hq, Hkv, D, NB, bs, K):
    r = _rng(seed)
    q = r.standard_normal((B, Hq, D), dtype=np.float32)
    kp = r.standard_normal((B, Hkv, NB, bs, D), dtype=np.float32)
    vp = r.standard_normal((B, Hkv, NB, bs, D), dtype=np.float32)
    idx = np.argsort(r.random((B, Hkv, NB)), axis=-1)[..., :K].astype(
        np.int32)
    valid = r.random((B, Hkv, K)) > 0.25
    # ragged: cur_len lands inside a block, some selected blocks beyond it
    cur_len = r.integers(bs + 1, NB * bs, size=(B,)).astype(np.int32)
    return q, kp, vp, idx, valid, cur_len


# ---------------------------------------------------------------------------
# sparse_decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,D,NB,bs,K", [
    (2, 14, 2, 64, 12, 8, 5),       # G = 7 (qwen2-0.5b's group)
    (3, 8, 2, 32, 9, 16, 4),        # G = 4 (llama3-8b's group)
    (1, 3, 3, 16, 6, 8, 6),         # MHA, every block selected
])
def test_sparse_decode_attention_plain_matches_pallas(B, Hq, Hkv, D, NB,
                                                      bs, K):
    q, kp, vp, idx, valid, cur_len = _attn_inputs(B * 10 + Hq, B, Hq, Hkv,
                                                  D, NB, bs, K)
    valid[0, 0] = False             # one row with no valid position -> 0
    got = ops.sparse_decode_attention(_t(q), _t(kp), _t(vp), _t(idx),
                                      _t(valid), _t(cur_len))
    want = jops.sparse_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(idx),
                                        jnp.asarray(valid),
                                        jnp.asarray(cur_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    G = Hq // Hkv
    assert not got[0, :G].any()     # the kernel's empty-row convention
    assert ops.launches.counts["sparse_decode_attention"] == 0


def test_sparse_decode_attention_plain_matches_dsa_ref_on_nonempty_rows():
    q, kp, vp, idx, valid, cur_len = _attn_inputs(5, 2, 14, 2, 32, 10, 8, 6)
    valid[:, :, 0] = True
    idx[:, :, 0] = 0                # block 0 always selected: never empty
    got = ref.sparse_decode_attention(_t(q), _t(kp), _t(vp), _t(idx),
                                      _t(valid), _t(cur_len))
    want = jref.sparse_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(idx),
                                        jnp.asarray(valid),
                                        jnp.asarray(cur_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# block_score (port reads the pool's interleaved (…, 2, D) metadata)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,D,NB", [(2, 14, 2, 64, 37),
                                           (1, 32, 8, 16, 130),
                                           (3, 7, 7, 8, 5)])
def test_block_score_plain_matches_pallas_and_ref(B, Hq, Hkv, D, NB):
    r = _rng(NB)
    q = r.standard_normal((B, Hq, D), dtype=np.float32)
    mn = r.standard_normal((B, Hkv, NB, D), dtype=np.float32)
    mx = mn + r.random((B, Hkv, NB, D), dtype=np.float32)
    meta = np.stack([mn, mx], axis=3)
    got = ops.block_score(_t(q), _t(meta)).numpy()
    want_ref = np.asarray(jref.block_score(jnp.asarray(q), jnp.asarray(mn),
                                           jnp.asarray(mx)))
    want_pallas = np.asarray(jops.block_score(jnp.asarray(q),
                                              jnp.asarray(mn),
                                              jnp.asarray(mx), nb_tile=16))
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# gather_blocks_hkv / scatter_blocks_hkv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,NB,bs,D,idx", [
    (2, 16, 8, 64, [3, 0, 15, 7, 7]),
    (1, 5, 32, 16, [4]),
    (8, 9, 4, 32, [8, 1, 2]),
])
def test_gather_blocks_plain_matches_pallas(H, NB, bs, D, idx):
    pool = _rng(H).standard_normal((H, NB, bs, D), dtype=np.float32)
    ids = np.asarray(idx, np.int32)
    got = ops.gather_blocks_hkv(_t(pool), _t(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.gather_blocks_hkv(
        jnp.asarray(pool), jnp.asarray(ids))))
    np.testing.assert_array_equal(got, np.asarray(jops.gather_blocks_hkv(
        jnp.asarray(pool), jnp.asarray(ids))))


def test_host_pool_gather_matches_reference_host_pool():
    """The gather source on the serving path is one layer of the host pool
    (a view into the (L, Hkv, NB, bs, D) tensor, pinned on the GPU): stage
    and flush the same stripes into both host pools, gather the same
    fragmented blocks, compare bit-exactly (with the same wire bytes)."""
    geom_j = jkv.KVGeometry(num_layers=3, num_kv_heads=2, block_size=8,
                            head_dim=16)
    geom_t = tkv.KVGeometry(num_layers=3, num_kv_heads=2, block_size=8,
                            head_dim=16)
    pj, pt = jkv.HostPool(geom_j, 6), tkv.HostPool(geom_t, 6)
    r = _rng(3)
    for layer, start, T in [(0, 0, 20), (1, 5, 30), (2, 0, 48), (1, 35, 1)]:
        k = r.standard_normal((2, T, 16), dtype=np.float32)
        v = r.standard_normal((2, T, 16), dtype=np.float32)
        assert pj.stage(layer, start, k, v) == pt.stage(layer, start, k, v)
    assert pj.flush() == pt.flush()
    for layer, blocks in [(1, [4, 0, 2]), (2, [5]), (0, [1, 2])]:
        kj, vj = pj.gather(layer, blocks)
        kt, vt = pt.gather(layer, blocks)
        np.testing.assert_array_equal(kt.numpy(), kj)
        np.testing.assert_array_equal(vt.numpy(), vj)
        assert pt.wire_bytes(len(blocks)) == pj.wire_bytes(len(blocks))
    with pytest.raises(ValueError):
        pt.gather(0, [6])


@pytest.mark.parametrize("H,NB,bs,D,dest", [(2, 16, 8, 64, [3, 9, 0]),
                                            (1, 4, 32, 16, [3]),
                                            (4, 10, 4, 8, [9, 2, 5, 7])])
def test_scatter_blocks_plain_matches_pallas(H, NB, bs, D, dest):
    r = _rng(NB)
    pool = r.standard_normal((H, NB, bs, D), dtype=np.float32)
    payload = r.standard_normal((H, len(dest), bs, D), dtype=np.float32)
    ids = np.asarray(dest, np.int32)
    pool_t = _t(pool)
    out = ops.scatter_blocks_hkv(pool_t, _t(payload), _t(ids))
    assert out is pool_t                              # in place
    want = np.asarray(jops.scatter_blocks_hkv(
        jnp.asarray(pool), jnp.asarray(payload), jnp.asarray(ids)))
    np.testing.assert_array_equal(pool_t.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jref.scatter_blocks_hkv(
        jnp.asarray(pool), jnp.asarray(payload), jnp.asarray(ids))))


def test_scatter_blocks_batched_rows_match_per_row_reference():
    """The port's batched form lands a whole batch's restores at once:
    (row, block) pairs into a (B, H, NB, bs, D) pool, equal to one
    reference scatter per row."""
    r = _rng(11)
    B, H, NB, bs, D = 3, 2, 7, 8, 16
    pool = r.standard_normal((B, H, NB, bs, D), dtype=np.float32)
    rows = np.asarray([2, 0, 2, 1], np.int32)
    dest = np.asarray([6, 6, 0, 3], np.int32)
    payload = r.standard_normal((H, 4, bs, D), dtype=np.float32)
    pool_t = _t(pool)
    ops.scatter_blocks_hkv(pool_t, _t(payload), _t(dest), _t(rows))
    want = pool.copy()
    for row in range(B):
        sel = np.nonzero(rows == row)[0]
        if len(sel):
            want[row] = np.asarray(jref.scatter_blocks_hkv(
                jnp.asarray(want[row]), jnp.asarray(payload[:, sel]),
                jnp.asarray(dest[sel])))
    np.testing.assert_array_equal(pool_t.numpy(), want)


def test_scatter_casts_payload_to_pool_dtype():
    pool = torch.zeros((2, 4, 8, 16), dtype=torch.bfloat16)
    payload = torch.randn((2, 2, 8, 16), generator=torch.Generator()
                          .manual_seed(0))
    ops.scatter_blocks_hkv(pool, payload, torch.tensor([1, 3],
                                                       dtype=torch.int32))
    assert torch.equal(pool[:, [1, 3]], payload.to(torch.bfloat16))
    assert not pool[:, [0, 2]].any()


@pytest.mark.parametrize("dtype,bs,D", [(np.int8, 32, 64), (np.float32, 1, 1)])
def test_write_blocks_plain_matches_pallas_scatter(dtype, bs, D):
    """The int8 tier's write back (an int8 pool, and its float32 scale
    plane as (H, NB, 1, 1) blocks) is the Pallas scatter of a payload of
    the pool's own dtype, byte for byte; other dtypes are refused."""
    r = _rng(bs)
    H, NB = 2, 9
    if dtype == np.int8:
        pool = r.integers(-127, 128, (H, NB, bs, D)).astype(np.int8)
        payload = r.integers(-127, 128, (H, 3, bs, D)).astype(np.int8)
    else:
        pool = r.random((H, NB, bs, D), dtype=np.float32)
        payload = r.random((H, 3, bs, D), dtype=np.float32)
    ids = np.asarray([8, 0, 4], np.int32)
    pool_t = _t(pool)
    assert ops.write_blocks_hkv(pool_t, _t(payload), _t(ids)) is pool_t
    want = np.asarray(jops.scatter_blocks_hkv(
        jnp.asarray(pool), jnp.asarray(payload), jnp.asarray(ids)))
    np.testing.assert_array_equal(pool_t.numpy(), want)
    assert ops.launches.counts["write_blocks_hkv"] == 0
    with pytest.raises(ValueError):
        ops.write_blocks_hkv(pool_t, _t(payload).double(), _t(ids))
