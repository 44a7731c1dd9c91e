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


# ---------------------------------------------------------------------------
# gather_blocks / scatter_blocks: the flat (NB, bs, D) FlashH2D / FlashD2H
# ---------------------------------------------------------------------------

_FLAT_DTYPES = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16),
                "int8": (torch.int8, jnp.int8)}


def _flat_pair(r, shape, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``
    (bf16 rounded from the same float32 values on both sides)."""
    t_dt, j_dt = _FLAT_DTYPES[dtype]
    if dtype == "int8":
        a = r.integers(-128, 128, shape).astype(np.int8)
        return torch.from_numpy(a), jnp.asarray(a)
    a = r.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(t_dt), jnp.asarray(a).astype(j_dt)


def _bits(x) -> np.ndarray:
    """The bytes of a torch tensor or a jax array, as integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("dtype", list(_FLAT_DTYPES))
@pytest.mark.parametrize("NB,bs,D,idx", [
    (16, 32, 64, [3, 9, 0, 15]),        # out of order
    (9, 8, 32, [1, 2, 3]),              # in order
    (64, 16, 128, [63, 0, 31, 7, 8]),
])
def test_flat_gather_plain_matches_pallas(dtype, NB, bs, D, idx):
    pool_t, pool_j = _flat_pair(_rng(NB), (NB, bs, D), dtype)
    ids = np.asarray(idx, np.int32)
    got = ops.gather_blocks(pool_t, _t(ids))
    assert got.shape == (len(idx), bs, D) and got.dtype == pool_t.dtype
    np.testing.assert_array_equal(_bits(got), _bits(jops.gather_blocks(
        pool_j, jnp.asarray(ids))))
    np.testing.assert_array_equal(_bits(got), _bits(jref.gather_blocks(
        pool_j, jnp.asarray(ids))))
    assert ops.launches.counts["gather_blocks"] == 0


@pytest.mark.parametrize("dtype", list(_FLAT_DTYPES))
@pytest.mark.parametrize("NB,bs,D,dest", [
    (16, 32, 64, [4, 11, 0]),           # out of order
    (9, 8, 32, [6, 7, 8]),              # in order
    (64, 16, 128, [40, 2, 63, 17]),
])
def test_flat_scatter_plain_matches_pallas(dtype, NB, bs, D, dest):
    """In place and byte for byte equal to the Pallas scatter (interpret
    mode) and the jnp oracle; untouched blocks persist, and a gather of the
    destination blocks after the scatter returns the payload."""
    r = _rng(NB + bs)
    pool_t, pool_j = _flat_pair(r, (NB, bs, D), dtype)
    new_t, new_j = _flat_pair(r, (len(dest) * bs, D), dtype)
    ids = np.asarray(dest, np.int32)
    before = pool_t.clone()
    assert ops.scatter_blocks(pool_t, new_t, _t(ids)) is pool_t
    want = jops.scatter_blocks(pool_j, new_j, jnp.asarray(ids))
    np.testing.assert_array_equal(_bits(pool_t), _bits(want))
    np.testing.assert_array_equal(_bits(want), _bits(jref.scatter_blocks(
        pool_j, new_j, jnp.asarray(ids))))
    keep = np.setdiff1d(np.arange(NB), ids)
    np.testing.assert_array_equal(_bits(pool_t[keep]), _bits(before[keep]))
    back = ops.gather_blocks(pool_t, _t(ids))
    np.testing.assert_array_equal(_bits(back.reshape(-1, D)), _bits(new_t))
    assert ops.launches.counts["scatter_blocks"] == 0


def test_flat_scatter_refuses_a_malformed_payload():
    pool = torch.zeros((8, 4, 16))
    ids = torch.tensor([1, 5], dtype=torch.int32)
    with pytest.raises(ValueError):             # not n_new * bs rows
        ops.scatter_blocks(pool, torch.zeros((7, 16)), ids)
    with pytest.raises(ValueError):             # another dtype
        ops.scatter_blocks(pool, torch.zeros((8, 16), dtype=torch.float64),
                           ids)


@pytest.mark.parametrize("B,Hkv,K,want", [(4, 2, 64, 32), (1, 1, 64, 64),
                                          (8, 8, 64, 16), (4, 2, 51, 26),
                                          (64, 8, 64, 16), (2, 1, 3, 3),
                                          (8, 8, 51, 13)])
def test_decode_splits_cover_k_in_equal_runs(B, Hkv, K, want):
    """The split-K attention's split count on a 132-SM card: runs of
    ceil(K / splits) <= 4 blocks cover the K selected blocks with none
    empty, and B * Hkv * splits reaches about 2 x 132 CTAs where K allows
    it (the serve's B 4 x Hkv 2 x K 64: 32 splits of 2 blocks)."""
    splits = ops.decode_splits(B, Hkv, K, 132)
    per = -(-K // splits)
    assert splits == want
    assert (splits - 1) * per < K <= splits * per
    assert per <= ops.DECODE_RUN


@pytest.mark.parametrize("G,tiles,B,Hkv,K,want", [
    (48, 3, 4, 1, 64, 22),     # granite-20b: three group tiles of 16 rows
    (20, 2, 4, 2, 51, 17),     # a last tile of 4 rows
    (16, 1, 4, 2, 64, 32),     # one tile: the splits of the fp serve
    (1, 1, 1, 32, 64, 16),     # lwm-7b's MHA: 32 kv heads, G = 1
])
def test_decode_splits_count_the_group_tiles(G, tiles, B, Hkv, K, want):
    """A GQA group above 16 rows runs in tiles of 16 rows, each a CTA per
    split, and the split count counts them: B * Hkv * tiles * splits
    reaches about 2 x 132 CTAs where K allows it."""
    assert ops.decode_group_tiles(G) == tiles
    splits = ops.decode_splits(B, Hkv, K, 132, tiles)
    assert splits == want
    assert -(-K // splits) <= ops.DECODE_RUN


def test_select_limit_follows_shared_memory():
    """score_select takes NB while 8 * G * D + 4 * NB bytes fit the
    opt-in shared memory: llama3-8b's 262,144-token context (NB 8193) and
    granite-20b's group fit, a group whose q rows alone overflow does
    not."""
    assert ops.select_max_nb(4, 128) == (ops.SMEM_OPTIN_BYTES - 4096) // 4
    assert ops.select_max_nb(4, 128) >= 8193
    assert ops.select_max_nb(48, 128) >= 8193
    assert ops.select_max_nb(256, 128) == 0


# ---------------------------------------------------------------------------
# device dispatch: the plain version only when every tensor is on the CPU
# ---------------------------------------------------------------------------

def _wrapper_args(name):
    """(wrapper, its tensor arguments, keyword arguments) at tiny shapes the
    kernels would take (bf16 activations and pools, int32 ids)."""
    g = torch.Generator().manual_seed(0)
    bf, i32 = torch.bfloat16, torch.int32

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    ids = torch.tensor([3, 0, 5], dtype=i32)
    rows = torch.tensor([1, 0, 1], dtype=i32)
    qi8 = torch.randint(-127, 128, (2, 3, 4, 16), generator=g,
                        dtype=torch.int8)
    calls = {
        "sparse_decode_attention": (ops.sparse_decode_attention, [
            randn(2, 4, 16, dtype=bf), randn(2, 2, 8, 4, 16, dtype=bf),
            randn(2, 2, 8, 4, 16, dtype=bf),
            torch.tensor([[[1, 4, 6]] * 2] * 2, dtype=i32),
            torch.ones((2, 2, 3), dtype=torch.bool),
            torch.tensor([30, 17], dtype=i32)], {}),
        "block_score": (ops.block_score, [randn(2, 4, 16, dtype=bf),
                                          randn(2, 2, 8, 2, 16)], {}),
        "gather_blocks_hkv": (ops.gather_blocks_hkv,
                              [randn(2, 8, 4, 16), ids], {}),
        "scatter_blocks_hkv": (ops.scatter_blocks_hkv, [
            randn(2, 8, 4, 16, dtype=bf), randn(2, 3, 4, 16), ids], {}),
        "scatter_blocks_hkv:rows": (ops.scatter_blocks_hkv, [
            randn(2, 2, 8, 4, 16, dtype=bf), randn(2, 3, 4, 16), ids,
            rows], {}),
        "write_blocks_hkv": (ops.write_blocks_hkv, [
            torch.zeros((2, 8, 4, 16), dtype=torch.int8), qi8, ids], {}),
        "gather_blocks": (ops.gather_blocks, [randn(8, 4, 16), ids], {}),
        "scatter_blocks": (ops.scatter_blocks, [randn(8, 4, 16),
                                                randn(12, 16), ids], {}),
        "flash_prefill": (ops.flash_prefill, [
            randn(1, 5, 4, 64, dtype=bf), randn(1, 5, 2, 64, dtype=bf),
            randn(1, 5, 2, 64, dtype=bf)], {"scale": 0.125}),
        "dequantize_blocks": (ops.dequantize_blocks,
                              [qi8, torch.rand((2, 3), generator=g)], {}),
        "dequantize_scatter_blocks": (ops.dequantize_scatter_blocks, [
            randn(2, 8, 4, 16, dtype=bf), qi8,
            torch.rand((2, 3), generator=g), ids], {}),
        "dequantize_scatter_blocks:rows": (ops.dequantize_scatter_blocks, [
            randn(2, 2, 8, 4, 16, dtype=bf), qi8,
            torch.rand((2, 3), generator=g), ids, rows], {}),
    }
    return calls[name]


_DISPATCH_CASES = [(name, pos) for name, n in (
    ("sparse_decode_attention", 6), ("block_score", 2),
    ("gather_blocks_hkv", 2), ("scatter_blocks_hkv", 3),
    ("scatter_blocks_hkv:rows", 4), ("write_blocks_hkv", 3),
    ("gather_blocks", 2), ("scatter_blocks", 3), ("flash_prefill", 3),
    ("dequantize_blocks", 2), ("dequantize_scatter_blocks", 4),
    ("dequantize_scatter_blocks:rows", 5)) for pos in [None, *range(n)]]


@pytest.mark.parametrize("name,moved", _DISPATCH_CASES)
def test_wrapper_takes_plain_version_only_when_all_on_cpu(name, moved):
    """With every tensor on the CPU a wrapper returns its plain version;
    with one of them elsewhere (here the ``meta`` device, standing in for
    the card) it raises ValueError rather than run the plain version on a
    mix of devices, and counts no launch."""
    fn, args, kw = _wrapper_args(name)
    ops.launches.reset()
    if moved is None:
        out = fn(*args, **kw)
        assert all(t.device.type == "cpu"
                   for t in (out if isinstance(out, tuple) else (out,)))
    else:
        args[moved] = args[moved].to("meta")
        with pytest.raises(ValueError):
            fn(*args, **kw)
    assert sum(ops.launches.counts.values()) == 0
