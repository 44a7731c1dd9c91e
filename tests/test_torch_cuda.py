"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so every test here carries the
``gpu`` marker and skips without a card.  This file imports neither jax
nor the reference package, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax).  Tolerances as in
``chip_smoke.py``: gather and scatter bit-exact; block scores 1e-3 + 1e-4
relative (float32 sums in another order); attention outputs in bf16
2e-3 + 1e-2 relative (both accumulate in float32 and round once to bf16,
whose step is <= 2^-7 relative), tight enough to reject a kernel that
masks one block wrong."""
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D,bs", [(14, 2, 64, 32), (32, 8, 128, 32),
                                         (7, 1, 32, 8), (48, 1, 128, 32),
                                         (64, 1, 128, 32)])
def test_attention_and_score_kernels_match_plain(cuda, Hq, Hkv, D, bs):
    g = _gen(cuda)
    B, NB, K = 3, 12, 5
    q = torch.randn((B, Hq, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((B, Hkv, NB, bs, D), generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn((B, Hkv, NB, bs, D), generator=g,
                     device=cuda).bfloat16()
    idx = torch.rand((B, Hkv, NB), generator=g, device=cuda).argsort(
        -1)[..., :K].int().contiguous()
    valid = torch.rand((B, Hkv, K), generator=g, device=cuda) > 0.2
    valid[0, 0] = False
    cur_len = torch.tensor([NB * bs, bs + 3, 5 * bs], dtype=torch.int32,
                           device=cuda)
    got = ops.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    want = ref.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=1e-2)
    assert not got[0, :Hq // Hkv].any()
    mn = torch.randn((B, Hkv, NB, D), generator=g, device=cuda)
    meta = torch.stack([mn, mn + 1.0], dim=3).contiguous()
    torch.testing.assert_close(ops.block_score(q, meta),
                               ref.block_score(q, meta), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.gpu
def test_block_move_kernels_match_plain(cuda):
    host = torch.randn((2, 12, 32, 64)).pin_memory()
    ids = torch.tensor([3, 0, 11], dtype=torch.int32)
    assert torch.equal(ops.gather_blocks_hkv(host, ids.to(cuda)),
                       ref.gather_blocks_hkv(host, ids).to(cuda))
    dev_pool = host.to(cuda).bfloat16()
    assert torch.equal(ops.gather_blocks_hkv(dev_pool, ids.to(cuda)),
                       ref.gather_blocks_hkv(dev_pool, ids.to(cuda)))
    pool = torch.zeros((2, 2, 12, 32, 64), dtype=torch.bfloat16,
                       device=cuda)
    pay = torch.randn((2, 3, 32, 64), generator=_gen(cuda), device=cuda)
    rows = torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda)
    want = ref.scatter_blocks_hkv(pool.clone(), pay, ids.to(cuda), rows)
    ops.scatter_blocks_hkv(pool, pay, ids.to(cuda), rows)
    assert torch.equal(pool, want)
    # a drop: bf16 blocks into one row's pool (no rows)
    row = pool[1].clone()
    zero = torch.zeros((2, 3, 32, 64), dtype=torch.bfloat16, device=cuda)
    want = ref.scatter_blocks_hkv(row.clone(), zero, ids.to(cuda))
    ops.scatter_blocks_hkv(row, zero, ids.to(cuda))
    assert torch.equal(row, want)


@pytest.mark.gpu
def test_attention_tolerance_rejects_a_block_masked_wrong(cuda):
    """cur_len one block short, or one live selection dropped, must fail
    the tolerance the kernel is held to."""
    g = _gen(cuda, 1)
    B, Hq, Hkv, D, bs, NB, K = 2, 14, 2, 64, 32, 24, 8
    q = torch.randn((B, Hq, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((B, Hkv, NB, bs, D), generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn((B, Hkv, NB, bs, D), generator=g,
                     device=cuda).bfloat16()
    cur_len = torch.tensor([20 * bs + 5, 9 * bs + 1], dtype=torch.int32,
                           device=cuda)
    last = (cur_len.long() - 1) // bs
    # the block holding cur_len - 1 and the K - 1 blocks before it
    idx = torch.stack([last - i for i in range(K)], -1)
    idx = idx[:, None].expand(B, Hkv, K).int().contiguous()
    valid = torch.ones((B, Hkv, K), dtype=torch.bool, device=cuda)
    want = ref.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    torch.testing.assert_close(
        ops.sparse_decode_attention(q, kp, vp, idx, valid, cur_len).float(),
        want.float(), atol=2e-3, rtol=1e-2)
    flipped = valid.clone()
    flipped[1, 0, 1] = False
    for args in ((q, kp, vp, idx, valid, cur_len - bs),
                 (q, kp, vp, idx, flipped, cur_len)):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(
                ops.sparse_decode_attention(*args).float(), want.float(),
                atol=2e-3, rtol=1e-2)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 64), device=cuda)
    meta = torch.zeros((1, 2, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.block_score(q.bfloat16(), meta)       # meta must be float32
    with pytest.raises(ValueError):
        ops.block_score(q, meta.float())          # q must be bfloat16
    with pytest.raises(ValueError):
        ops.gather_blocks_hkv(torch.zeros((2, 8, 32, 64)),
                              torch.zeros(3, dtype=torch.int32,
                                          device=cuda))   # not pinned


# ---------------------------------------------------------------------------
# slice 2: flash_prefill and the int8 tier's quant kernels
# ---------------------------------------------------------------------------
# flash_prefill is held per output element to |err| <= 1.25 * 2^-8 W +
# 2^-7 |ref| against the float32 plain version, W = sum_j p_j |v_j| /
# sum_j p_j (the plain version run on |v|): the kernel rounds each weight
# to bf16 before P V (unit roundoff 2^-8, so <= 2^-8 W on the element),
# its float32 scores, exponentials and sums differ by far less (budgeted
# at 2^-10 W), and both sides round the output once to bf16 (one step,
# <= 2^-7 |ref|).  The quant kernels are bit-exact.

def _flash_close(out, q, k, v, **kw):
    want = ref.flash_prefill(q, k, v, **kw)
    weight = ref.flash_prefill(q.float(), k.float(), v.float().abs(), **kw)
    err = (out.float() - want.float()).abs()
    bound = 1.25 * 2.0 ** -8 * weight + 2.0 ** -7 * want.float().abs()
    return bool((err <= bound).all())


def _probe(q, k, v, qi, kj, scale):
    """Plant key ``kj`` so that query row ``qi`` (the first head of each
    GQA group) puts nearly all its weight on it (score 30), with value 8:
    a kernel that shows that key to that query, or hides it, wrongly moves
    the output by O(1)."""
    k, v = k.clone(), v.clone()
    Hkv = k.shape[2]
    G = q.shape[2] // Hkv
    qh = q[:, qi, ::G].float()                          # (B, Hkv, D)
    k[:, kj] = (qh * (30.0 / (scale * (qh * qh).sum(-1, keepdim=True)))
                ).to(k.dtype)
    v[:, kj] = 8.0
    return k, v


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D", [(14, 2, 64), (32, 8, 128)])
@pytest.mark.parametrize("Sq,q_offset", [(200, 0), (130, 70), (3, 0),
                                         (257, 300)])
def test_flash_prefill_matches_plain(cuda, Hq, Hkv, D, Sq, q_offset):
    """q_offset 0, and a chunk continuation whose earlier keys lie ahead of
    the window (Sk = q_offset + Sq); neither length fills a 64-row tile.
    Two planted faults must fail the tolerance: the kernel run with
    q_offset one too large, and with the last key dropped."""
    g = _gen(cuda, 2)
    B, Sk = 2, q_offset + Sq
    scale = D ** -0.5
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).bfloat16()
    got = ops.flash_prefill(q, k, v, scale=scale, q_offset=q_offset)
    assert _flash_close(got, q, k, v, scale=scale, q_offset=q_offset)
    # q_offset off by one: query 0 would see the key after its own
    kp, vp = _probe(q, k, v, 0, q_offset + 1, scale)
    assert not _flash_close(ops.flash_prefill(
        q, kp, vp, scale=scale, q_offset=q_offset + 1), q, kp, vp,
        scale=scale, q_offset=q_offset)
    # the last key dropped: only the last query sees it
    kp, vp = _probe(q, k, v, Sq - 1, Sk - 1, scale)
    assert not _flash_close(ops.flash_prefill(
        q, kp[:, :-1].contiguous(), vp[:, :-1].contiguous(), scale=scale,
        q_offset=q_offset), q, kp, vp, scale=scale, q_offset=q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D", [(14, 2, 64), (32, 8, 128)])
@pytest.mark.parametrize("Sq,q_offset", [(1000, 0), (1000, 1000)])
def test_flash_prefill_tolerance_rejects_a_late_tile_dropped(
        cuda, Hq, Hkv, D, Sq, q_offset):
    """A kernel that skips one interior key tile for the queries of the
    window's second half only (long rows, each moved by ~64 / n of its
    values' spread) must fail the per-element tolerance, while the kernel
    itself passes it on the same inputs."""
    g = _gen(cuda, 5)
    B, Sk = 2, q_offset + Sq
    kw = dict(scale=D ** -0.5, q_offset=q_offset)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).bfloat16()
    out = ops.flash_prefill(q, k, v, **kw)
    assert _flash_close(out, q, k, v, **kw)
    h = Sq // 2 // 64 * 64
    k0 = (q_offset + h) // 2 // 64 * 64
    assert k0 + 64 <= q_offset + h           # every late query sees it

    def cut(x):
        return torch.cat([x[:, :k0], x[:, k0 + 64:]], dim=1).contiguous()
    # among the cut keys, the query at position p sees those up to p - 64
    out[:, h:] = ops.flash_prefill(q[:, h:].contiguous(), cut(k), cut(v),
                                   scale=kw["scale"],
                                   q_offset=q_offset + h - 64)
    assert not _flash_close(out, q, k, v, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_match_plain_bit_exact(cuda, dtype):
    g = _gen(cuda, 3)
    H, K, bs, D, B, NB = 2, 9, 32, 64, 3, 12
    x = (torch.randn((H, K, bs, D), generator=g, device=cuda)
         * torch.rand((H, K, 1, 1), generator=g, device=cuda) * 4).to(dtype)
    x[1, 4] = 0                                    # an all-zero block
    q, s = ops.quantize_blocks(x)
    q_ref, s_ref = ref.quantize_blocks(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert s[1, 4] == 0 and not q[1, 4].any()
    assert torch.equal(ops.dequantize_blocks(q, s),
                       ref.dequantize_blocks(q, s))
    pool = torch.randn((B, H, NB, bs, D), generator=g,
                       device=cuda).bfloat16()
    dest = torch.randperm(NB, generator=g, device=cuda)[:K].int()
    rows = torch.randint(0, B, (K,), generator=g, device=cuda,
                         dtype=torch.int32)
    want = ref.dequantize_scatter_blocks(pool.clone(), q, s, dest, rows)
    assert torch.equal(ops.dequantize_scatter_blocks(pool, q, s, dest, rows),
                       want)
    row = pool[0].clone()
    want = ref.dequantize_scatter_blocks(row.clone(), q, s, dest)
    assert torch.equal(ops.dequantize_scatter_blocks(row, q, s, dest), want)


@pytest.mark.gpu
def test_int8_host_pool_on_the_card_writes_the_plain_bytes(cuda):
    """The int8 HostPool with device stripes (gather from the pinned pool,
    dequantize, overlay, quantize, write back through the byte-copy
    scatter) holds the same bytes as the CPU pool fed the same stripes;
    its gather returns the same payload and scales."""
    from repro_torch.core.kv_cache import HostPool, KVGeometry
    geom = KVGeometry(num_layers=2, num_kv_heads=2, block_size=32,
                      head_dim=64)
    gpu, cpu = HostPool(geom, 6, "int8", cuda), HostPool(geom, 6, "int8")
    g = torch.Generator().manual_seed(4)
    for layer, start, T in ((0, 0, 64), (1, 0, 45), (0, 64, 1), (0, 65, 40),
                            (1, 45, 30), (0, 105, 1)):
        k = torch.randn((2, T, 64), generator=g) * (1 + layer)
        v = torch.randn((2, T, 64), generator=g)
        assert (gpu.stage(layer, start, k.to(cuda), v.to(cuda))
                == cpu.stage(layer, start, k.numpy(), v.numpy()))
        assert gpu.flush() == cpu.flush()
        torch.cuda.synchronize()
        for a, b in ((gpu.k, cpu.k), (gpu.v, cpu.v),
                     (gpu.k_scale, cpu.k_scale), (gpu.v_scale, cpu.v_scale)):
            assert torch.equal(a, b)
    (kq, ks), _ = gpu.gather(0, [3, 0, 2])
    (kq_c, ks_c), _ = cpu.gather(0, [3, 0, 2])
    assert torch.equal(kq.cpu(), kq_c) and torch.equal(ks.cpu(), ks_c)


@pytest.mark.gpu
def test_write_blocks_kernel_matches_plain(cuda):
    """write_blocks_hkv into a pinned int8 pool and its float32 scale
    plane, and into a device pool: the plain version's bytes."""
    g = torch.Generator().manual_seed(6)
    ids = torch.tensor([4, 0, 9], dtype=torch.int32)
    for pool in (torch.randint(-127, 128, (2, 12, 32, 64), generator=g,
                               dtype=torch.int8),
                 torch.rand((2, 12, 1, 1), generator=g)):
        pay = pool[:, 5:8].clone()
        want = ref.write_blocks_hkv(pool.clone(), pay, ids)
        pinned = pool.clone().pin_memory()
        ops.write_blocks_hkv(pinned, pay.to(cuda), ids.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(pinned, want)
        on_dev = pool.to(cuda)
        ops.write_blocks_hkv(on_dev, pay.to(cuda), ids.to(cuda))
        assert torch.equal(on_dev.cpu(), want)


@pytest.mark.gpu
def test_slice2_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):     # float32, in the non-causal mode
        ops.flash_prefill(q.float(), q.float(), q.float(), scale=0.125,
                          causal=False)
    with pytest.raises(ValueError):
        ops.flash_prefill(q.float(), q.float(), q.float(), scale=0.125)
    with pytest.raises(ValueError):                   # head dim 32
        ops.flash_prefill(q[..., :32].contiguous(), q[..., :32].contiguous(),
                          q[..., :32].contiguous(), scale=0.125)
    with pytest.raises(ValueError):                   # int8 blocks
        ops.quantize_blocks(torch.zeros((2, 3, 32, 64), dtype=torch.int8,
                                        device=cuda))
    qb = torch.zeros((2, 3, 32, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):                   # bf16 scales
        ops.dequantize_blocks(qb, torch.zeros((2, 3), device=cuda,
                                              dtype=torch.bfloat16))
    with pytest.raises(ValueError):                   # float32 pool
        ops.dequantize_scatter_blocks(
            torch.zeros((2, 8, 32, 64), device=cuda), qb,
            torch.zeros((2, 3), device=cuda),
            torch.zeros(3, dtype=torch.int32, device=cuda))
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                   # a host payload
        ops.scatter_blocks_hkv(
            torch.zeros((2, 8, 32, 64), device=cuda, dtype=torch.bfloat16),
            torch.zeros((2, 3, 32, 64)), ids)
    with pytest.raises(ValueError):                   # a host pool
        ops.scatter_blocks_hkv(
            torch.zeros((2, 8, 32, 64), dtype=torch.bfloat16).pin_memory(),
            torch.zeros((2, 3, 32, 64), device=cuda), ids)
    with pytest.raises(ValueError):                   # dtypes differ
        ops.write_blocks_hkv(
            torch.zeros((2, 8, 32, 64), dtype=torch.int8).pin_memory(),
            torch.zeros((2, 3, 32, 64), device=cuda), ids)
    with pytest.raises(ValueError):                   # not pinned
        ops.write_blocks_hkv(torch.zeros((2, 8, 32, 64), dtype=torch.int8),
                             qb, ids)


# ---------------------------------------------------------------------------
# slice 3: the flat FlashH2D gather / FlashD2H scatter; split-K decode
# attention
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("where", ["pinned", "device"])
def test_flat_block_kernels_match_plain(cuda, dtype, where):
    """gather_blocks and scatter_blocks byte for byte against their plain
    versions, from and into a pinned host pool and a device pool; a
    scatter leaves the other blocks as they were, and a gather after it
    returns the payload."""
    g = torch.Generator().manual_seed(7)
    NB, bs, D = 40, 16, 64
    if dtype == torch.int8:
        pool = torch.randint(-127, 128, (NB, bs, D), generator=g,
                             dtype=torch.int8)
        new = torch.randint(-127, 128, (3 * bs, D), generator=g,
                            dtype=torch.int8)
    else:
        pool = torch.randn((NB, bs, D), generator=g).to(dtype)
        new = torch.randn((3 * bs, D), generator=g).to(dtype)
    ids = torch.tensor([17, 2, 39, 5, 30], dtype=torch.int32)
    dest = torch.tensor([33, 0, 12], dtype=torch.int32)
    src = pool.clone().pin_memory() if where == "pinned" else pool.to(cuda)
    got = ops.gather_blocks(src, ids.to(cuda))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), ref.gather_blocks(pool, ids))
    want = ref.scatter_blocks(pool.clone(), new, dest)
    assert ops.scatter_blocks(src, new.to(cuda), dest.to(cuda)) is src
    torch.cuda.synchronize()
    assert torch.equal(src.cpu(), want)
    keep = torch.ones(NB, dtype=torch.bool)
    keep[dest.long()] = False
    assert torch.equal(src.cpu()[keep], pool[keep])
    back = ops.gather_blocks(src, dest.to(cuda))
    assert torch.equal(back.reshape(3 * bs, D).cpu(), new)


@pytest.mark.gpu
def test_flat_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pool = torch.zeros((8, 16, 64), device=cuda)
    ids = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                   # not pinned
        ops.gather_blocks(torch.zeros((8, 16, 64)), ids)
    with pytest.raises(ValueError):                   # int64 ids
        ops.gather_blocks(pool, ids.long())
    with pytest.raises(ValueError):                   # a device pool, host ids
        ops.gather_blocks(pool, ids.cpu())
    with pytest.raises(ValueError):
        ops.gather_blocks_hkv(pool[None], ids.cpu())
    with pytest.raises(ValueError):                   # a host payload
        ops.scatter_blocks(pool, torch.zeros((32, 64)), ids)
    with pytest.raises(ValueError):                   # dtypes differ
        ops.scatter_blocks(pool, torch.zeros((32, 64), device=cuda,
                                             dtype=torch.bfloat16), ids)
    with pytest.raises(ValueError):                   # not n_new * bs rows
        ops.scatter_blocks(pool, torch.zeros((31, 64), device=cuda), ids)
    with pytest.raises(ValueError):                   # not contiguous
        ops.scatter_blocks(pool, torch.zeros((64, 32), device=cuda).t(), ids)
    with pytest.raises(ValueError):                   # int64 ids
        ops.scatter_blocks(pool, torch.zeros((32, 64), device=cuda),
                           ids.long())


def _decode_inputs(dev, seed, B, Hq, Hkv, D, NB, bs, K):
    g = _gen(dev, seed)
    q = torch.randn((B, Hq, D), generator=g, device=dev).bfloat16()
    kp = torch.randn((B, Hkv, NB, bs, D), generator=g,
                     device=dev).bfloat16()
    vp = torch.randn((B, Hkv, NB, bs, D), generator=g,
                     device=dev).bfloat16()
    idx = torch.rand((B, Hkv, NB), generator=g, device=dev).argsort(
        -1)[..., :K].int().contiguous()
    valid = torch.rand((B, Hkv, K), generator=g, device=dev) > 0.5
    return q, kp, vp, idx, valid


@pytest.mark.gpu
@pytest.mark.parametrize("G", [7, 4, 16, 20, 48])
@pytest.mark.parametrize("B,Hkv,K", [(1, 1, 64), (4, 2, 51), (8, 8, 51)])
def test_split_decode_attention_matches_plain(cuda, G, B, Hkv, K):
    """Split-K decode attention against the plain version, at split counts
    that leave splits with no valid block (B 1 x Hkv 1: one block per
    split, half of them invalid), with K not a multiple of the split size
    (K 51 in runs of 2 and of 4), an all-invalid row (output 0), and
    cur_len cutting blocks mid-way; G above 16 in group tiles of 16 rows
    (G 20: a last tile of 4 rows; G 48: granite-20b's three)."""
    bs, D, NB = 32, 64, 80
    q, kp, vp, idx, valid = _decode_inputs(cuda, G + K, B, G * Hkv, Hkv, D,
                                           NB, bs, K)
    cur_len = torch.randint(bs, NB * bs, (B,), generator=_gen(cuda, K),
                            device=cuda, dtype=torch.int32)
    cur_len[0] = 37 * bs + 5                        # mid-block
    splits = ops.decode_splits(B, Hkv, K, ops._sm_count(cuda),
                               ops.decode_group_tiles(G))
    per = -(-K // splits)
    if B * Hkv == 1:
        assert per == 1 and not valid.all()         # empty splits
    else:
        if ops.decode_group_tiles(G) == 1:
            assert K % per != 0
        valid[-1, -1] = False                       # an all-invalid row
    got = ops.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    want = ref.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=1e-2)
    if B * Hkv > 1:
        assert not got[-1, -G:].any()


@pytest.mark.gpu
def test_split_decode_attention_dv_differs(cuda):
    """Dv != D (MLA's attend: the value pool wider than the key pool)."""
    B, Hq, Hkv, D, Dv, NB, bs, K = 2, 16, 1, 64, 128, 20, 16, 12
    q, kp, _, idx, valid = _decode_inputs(cuda, 9, B, Hq, Hkv, D, NB, bs, K)
    vp = torch.randn((B, Hkv, NB, bs, Dv), generator=_gen(cuda, 10),
                     device=cuda).bfloat16()
    cur_len = torch.tensor([NB * bs, 7 * bs + 3], dtype=torch.int32,
                           device=cuda)
    got = ops.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    want = ref.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    assert got.shape == (B, Hq, Dv)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=1e-2)


# ---------------------------------------------------------------------------
# slice 4: the eviction round's zero-fill; block_score fused with the top-k
# select
# ---------------------------------------------------------------------------
# zero_blocks_hkv is bit-exact.  score_select is held tie-aware: per
# (request, kv-head) sel_valid counts equal, the plain version's select
# scores of the selected blocks equal as sorted lists (1e-3 + 1e-4
# relative, the block-score tolerance; +inf and the masked score exactly),
# no block selected twice, and the id sets equal wherever the K-th and
# (K+1)-th of those scores differ by more than the tolerance.

def _select_agrees(idx, valid, want_idx, want_valid, s_ref, atol=1e-3,
                   rtol=1e-4) -> bool:
    def close(a, b):
        return (a == b) | (torch.isfinite(a) & torch.isfinite(b)
                           & ((a - b).abs() <= atol + rtol * b.abs()))
    if not torch.equal(valid.sum(-1), want_valid.sum(-1)):
        return False
    picked = [torch.gather(s_ref, -1, i.long()).masked_fill(
        ~v, float("-inf")).sort(-1, descending=True).values
        for i, v in ((idx, valid), (want_idx, want_valid))]
    if not close(*picked).all():
        return False
    counts = [torch.zeros(s_ref.shape, dtype=torch.int32,
                          device=s_ref.device).scatter_add_(
        -1, i.long(), v.int()) for i, v in ((idx, valid),
                                            (want_idx, want_valid))]
    if counts[0].max() > 1:
        return False
    K, NB = idx.shape[-1], s_ref.shape[-1]
    if K < NB:
        top = s_ref.sort(-1, descending=True).values
        gap = ~close(top[..., K - 1], top[..., K])
        if not (counts[0] == counts[1])[gap].all():
            return False
    return True


def _select_case(dev, B, Hq, Hkv, D, NB, bs, seed=0):
    g = _gen(dev, seed)
    q = torch.randn((B, Hq, D), generator=g, device=dev).bfloat16()
    mn = torch.randn((B, Hkv, NB, D), generator=g, device=dev)
    mx = mn + torch.rand((B, Hkv, NB, D), generator=g, device=dev)
    mn[:, :, 5:9], mx[:, :, 5:9] = mn[:, :, 4:5], mx[:, :, 4:5]  # ties
    meta = torch.stack([mn, mx], dim=3).contiguous()
    cur_len = torch.randint(0, NB * bs, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    cur_len[0] = (NB // 2) * bs            # the step's +1 opens a block
    return q, meta, cur_len


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,D,NB,bs,top_k,sink,recent", [
    (4, 14, 2, 64, 136, 32, 64, 1, 2),     # the fp serve's decode step
    (3, 32, 8, 128, 37, 32, 64, 1, 2),     # NB not a multiple of 32, K > NB
    (2, 7, 7, 32, 1000, 8, 100, 0, 0),     # no forcing, 8 blocks per pass
    (1, 4, 1, 64, 4096, 32, 64, 2, 3),     # NB 4096 (radix select)
    (4, 48, 1, 128, 258, 32, 64, 1, 2),    # granite-20b's group, G * D
    #                                        alone 48 KB
    (2, 32, 8, 128, 4097, 32, 64, 1, 2),   # llama3-8b past 4096 blocks
    (1, 32, 8, 128, 8193, 32, 64, 1, 2),   # its 262,144-token context
    (2, 4, 1, 64, 600, 32, 600, 0, 0),     # K == NB on the radix path
    (2, 64, 1, 128, 2000, 32, 64, 1, 2),   # 64 KB of q rows, opted in
])
def test_score_select_kernel_matches_plain(cuda, B, Hq, Hkv, D, NB, bs,
                                           top_k, sink, recent):
    q, meta, cur_len = _select_case(cuda, B, Hq, Hkv, D, NB, bs)
    kw = dict(block_size=bs, top_k=top_k, sink_blocks=sink,
              recent_blocks=recent)
    idx, valid = ops.score_select(q, meta, cur_len, **kw)
    want_idx, want_valid = ref.score_select(q, meta, cur_len, **kw)
    s_ref = ref.select_scores(ref.block_score(q, meta), cur_len + 1,
                              block_size=bs, sink_blocks=sink,
                              recent_blocks=recent)
    assert idx.shape == want_idx.shape == (B, Hkv, min(top_k, NB))
    assert _select_agrees(idx, valid, want_idx, want_valid, s_ref)
    assert not idx[~valid].any()
    # the kernel orders by score, highest first (within the tolerance:
    # its sums are taken in another order)
    picked = torch.gather(s_ref, -1, idx.long()).masked_fill(
        ~valid, float("-inf"))
    hi, lo = picked[..., :-1], picked[..., 1:]
    slack = torch.where(torch.isfinite(lo), 1e-3 + 1e-4 * lo.abs(),
                        torch.zeros_like(lo))
    assert (hi >= lo - slack).all()
    # block_score's kernel body is the same scoring
    torch.testing.assert_close(ops.block_score(q, meta),
                               ref.block_score(q, meta), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.gpu
def test_select_check_rejects_planted_faults(cuda):
    """The kernel on inputs that plant a fault (cur_len without the step's
    +1; the recent-block forcing left out), held against the plain version
    on the true inputs, must fail the tie-aware check."""
    B, Hq, Hkv, D, NB, bs = 4, 14, 2, 64, 136, 32
    q, meta, cur_len = _select_case(cuda, B, Hq, Hkv, D, NB, bs, seed=3)
    kw = dict(block_size=bs, top_k=64, sink_blocks=1, recent_blocks=2)
    want = ref.score_select(q, meta, cur_len, **kw)
    s_ref = ref.select_scores(ref.block_score(q, meta), cur_len + 1,
                              block_size=bs, sink_blocks=1, recent_blocks=2)
    assert _select_agrees(*ops.score_select(q, meta, cur_len, **kw), *want,
                          s_ref)
    no_plus_one = ops.score_select(q, meta, cur_len - 1, **kw)
    no_recent = ops.score_select(q, meta, cur_len,
                                 **dict(kw, recent_blocks=0))
    for got in (no_plus_one, no_recent):
        assert not _select_agrees(*got, *want, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,NB,bs,D,layers", [(4, 2, 136, 32, 64, 24),
                                                (3, 8, 37, 16, 128, 3)])
def test_zero_blocks_kernel_matches_plain(cuda, B, H, NB, bs, D, layers):
    g = _gen(cuda)
    pools = [torch.randn((B, H, NB, bs, D), generator=g,
                         device=cuda).bfloat16() for _ in range(2 * layers)]
    r = torch.Generator().manual_seed(0)
    N = 300
    which = torch.randint(0, 2 * layers, (N,), generator=r).tolist()
    rows = torch.randint(0, B, (N,), generator=r).tolist()
    blocks = torch.randint(0, NB, (N,), generator=r).tolist()
    want = [p.clone() for p in pools]
    ref.zero_blocks_hkv(want, *(torch.tensor(a, device=cuda)
                                for a in (which, rows, blocks)))
    table = ops.PoolTable(pools)
    ops.launches.reset()
    ops.zero_blocks_hkv(table, which, rows, blocks)
    torch.cuda.synchronize()
    assert ops.launches.counts["zero_blocks_hkv"] == 1
    assert all(torch.equal(p, w) for p, w in zip(pools, want))
    assert len(set(which)) > 2 and len(set(rows)) > 1
    ops.zero_blocks_hkv(table, [], [], [])            # an empty round


@pytest.mark.gpu
def test_slice4_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pools = [torch.zeros((2, 2, 8, 32, 64), device=cuda,
                         dtype=torch.bfloat16) for _ in range(2)]
    with pytest.raises(ValueError):                   # not bf16
        ops.PoolTable([p.float() for p in pools])
    with pytest.raises(ValueError):                   # a mix of devices
        ops.zero_blocks_hkv([pools[0], pools[1].cpu()], [0], [0], [0])
    with pytest.raises(ValueError):                   # strides differ
        ops.zero_blocks_hkv([pools[0], pools[1].transpose(0, 1)], [0], [0],
                            [0])
    with pytest.raises(ValueError):                   # device ids
        ops.zero_blocks_hkv(pools, torch.zeros(1, dtype=torch.int32,
                                               device=cuda), [0], [0])
    with pytest.raises(IndexError):                   # block past NB
        ops.zero_blocks_hkv(pools, [1], [0], [8])
    with pytest.raises(IndexError):                   # scatter, row past B
        ops.scatter_blocks_hkv(pools[0], torch.zeros((2, 1, 32, 64),
                                                     device=cuda), [0], [2])
    q = torch.zeros((1, 4, 64), device=cuda, dtype=torch.bfloat16)
    cur = torch.zeros(1, dtype=torch.int32, device=cuda)
    kw = dict(block_size=32, top_k=64, sink_blocks=1, recent_blocks=2)
    big = torch.zeros((1, 2, ops.select_max_nb(2, 64) + 1, 2, 64),
                      device=cuda)
    with pytest.raises(ValueError):                   # NB above the limit
        ops.score_select(q, big, cur, **kw)
    meta = torch.zeros((1, 2, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError):                   # bf16 meta
        ops.score_select(q, meta.bfloat16(), cur, **kw)
    with pytest.raises(ValueError):                   # int64 cur_len
        ops.score_select(q, meta, cur.long(), **kw)
    with pytest.raises(ValueError):                   # a host cur_len
        ops.score_select(q, meta, cur.cpu(), **kw)


def _int8_pools(g, n, H, bs, D, L=2, NB=10, fresh=7):
    """n int8 pools (L, H, NB, bs, D) with their float32 scale planes;
    blocks from ``fresh`` on hold nothing yet (scale 0)."""
    out = []
    for _ in range(n):
        q = torch.randint(-127, 128, (L, H, NB, bs, D), generator=g,
                          dtype=torch.int8)
        s = torch.rand((L, H, NB), generator=g) * 0.1
        q[:, :, fresh:] = 0
        s[:, :, fresh:] = 0
        out.append((q, s))
    return out


def _quant_pools(pairs, where, dev):
    return [ops.QuantPool(*(t.clone().pin_memory() if where == "pinned"
                            else t.to(dev) for t in p)) for p in pairs]


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["pinned", "device"])
@pytest.mark.parametrize("H,bs,D", [(2, 8, 16), (2, 32, 64), (8, 32, 128),
                                    (1, 32, 288)])
def test_quant_save_kernel_matches_plain(cuda, H, bs, D, where):
    """quant_save_blocks equals its plain version bit for bit, pools in
    pinned memory or on the card: 3 requests' decode tokens (strided
    float32 views; into a resident block, at a fresh block's first slot
    and at a fresh block's last), a bfloat16 prefill stripe of 3 whole
    blocks seen through a permute, a float32 stripe from mid-block over 4
    blocks, and a second token into request 0's block: two launches.
    D 288 is MLA's one latent head (minicpm3-4b), the kernel's wide
    instance."""
    g = torch.Generator().manual_seed(H * D + bs)
    R = 3
    pools = _int8_pools(g, 2 * R, H, bs, D)
    kd = torch.randn((R, 2, H, D), generator=g).to(cuda)
    pre = torch.randn((3 * bs, H, D), generator=g).to(cuda, torch.bfloat16)
    mid = torch.randn((H, 2 * bs + 5, D), generator=g).to(cuda) * 3
    pos = (bs // 2, 7 * bs, 9 * bs + bs - 1)

    def saves(ps):
        out = [ops.QuantSave(ps[2 * i + kv], 1, pos[i],
                             kd[i, kv][:, None, :])
               for i in range(R) for kv in (0, 1)]
        return out + [ops.QuantSave(ps[0], 0, bs, pre.permute(1, 0, 2)),
                      ops.QuantSave(ps[3], 0, bs - 3, mid),
                      ops.QuantSave(ps[0], 1, pos[0] + 1,
                                    kd[1, 1][:, None, :])]
    got = _quant_pools(pools, where, cuda)
    want = [ops.QuantPool(*(t.clone() for t in p)) for p in pools]
    assert all(p.mapped is not None for p in got)
    assert all(p.mapped is None for p in want)
    ops.launches.reset()
    assert ops.quant_save_blocks(saves(got)) == 2 * R + 3 + 4 + 1
    torch.cuda.synchronize()
    assert ops.launches.counts["quant_save_blocks"] == 2
    ref.quant_save_blocks(saves(want))
    for g, w in zip(got, want):
        assert torch.equal(g.q.cpu(), w.q)
        assert torch.equal(g.scales.cpu(), w.scales)
    assert not torch.equal(want[0].q, pools[0][0])


@pytest.mark.gpu
def test_quant_save_rejects_what_the_kernel_does_not_take(cuda):
    g = torch.Generator().manual_seed(1)
    (q, s), = _int8_pools(g, 1, 2, 32, 64)
    stripe = torch.randn((2, 1, 64), device=cuda)
    strided = torch.randn((2, 1, 128), device=cuda)[..., ::2]
    on_card = ops.QuantPool(q.to(cuda), s.to(cuda))
    for pool, st in (
            (ops.QuantPool(q, s), stripe),                # pageable pool
            (on_card, stripe.cpu()),                      # a host stripe
            (on_card, stripe.double()),                   # float64
            (on_card, strided),                           # strided D
    ):
        with pytest.raises(ValueError):
            ops.quant_save_blocks([ops.QuantSave(pool, 0, 5, st)])
    with pytest.raises(ValueError):                   # a mix of devices
        ops.QuantPool(q.to(cuda), s.pin_memory())
    with pytest.raises(ValueError):                   # bs * D > 12288
        ops.QuantPool(torch.zeros((1, 2, 4, 64, 256), dtype=torch.int8,
                                  device=cuda),
                      torch.zeros((1, 2, 4), device=cuda))
    pinned = ops.QuantPool(q.pin_memory(), s.pin_memory())
    before = pinned.q.clone()
    with pytest.raises(IndexError):                   # block past NB
        ops.quant_save_blocks([ops.QuantSave(pinned, 0, 5, stripe),
                               ops.QuantSave(pinned, 1, 10 * 32, stripe)])
    torch.cuda.synchronize()
    assert torch.equal(pinned.q, before)


# ---------------------------------------------------------------------------
# slice 7: the decode kernels for any GQA group, score_select past 4096
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_slice7_wrappers_raise_beyond_their_limits(cuda):
    """The decode attention takes any G but D, Dv <= 320; score_select
    any G and NB while 8 * G * D + 4 * NB bytes fit the card's opt-in
    shared memory.  Beyond that each raises, naming
    the limit."""
    assert ops.select_max_nb(48, 128) >= 8193       # granite-20b
    assert ops.select_max_nb(4, 128) >= 8193        # llama3-8b
    bf = torch.bfloat16
    q = torch.zeros((1, 48, 328), device=cuda, dtype=bf)
    pool = torch.zeros((1, 1, 4, 32, 328), device=cuda, dtype=bf)
    idx = torch.zeros((1, 1, 2), device=cuda, dtype=torch.int32)
    valid = torch.ones((1, 1, 2), device=cuda, dtype=torch.bool)
    cur = torch.full((1,), 40, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="D, Dv <= 320"):
        ops.sparse_decode_attention(q, pool, pool, idx, valid, cur)
    kw = dict(block_size=32, top_k=64, sink_blocks=1, recent_blocks=2)
    q = torch.zeros((1, 48, 128), device=cuda, dtype=bf)
    nb = ops.select_max_nb(48, 128) + 1
    meta = torch.zeros((1, 1, nb, 2, 128), device=cuda)
    with pytest.raises(ValueError, match=f"NB <= {nb - 1}"):
        ops.score_select(q, meta, cur, **kw)
    huge = torch.zeros((1, 256, 128), device=cuda, dtype=bf)   # G 256
    meta = torch.zeros((1, 1, 8, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.score_select(huge, meta, cur, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        ops.block_score(huge, meta)


# ---------------------------------------------------------------------------
# MLA (minicpm3-4b): the decode kernels over one 288-wide latent head
# under G = 40, flash_prefill at q/k depth 96 and v width 64
# ---------------------------------------------------------------------------
# Tolerances as above.  The D = Dv paths of flash_prefill keep the
# earlier kernel's output bit for bit: the digests below are of the
# outputs of the kernel as it was before its (96, 64) instantiation was
# added, on these numpy-seeded inputs, on an H100.

MLA_SCALE = 96 ** -0.5


@pytest.mark.gpu
@pytest.mark.parametrize("B,G,D,K", [(4, 40, 288, 64), (2, 40, 288, 13),
                                     (1, 17, 320, 64)])
def test_mla_decode_attention_matches_plain(cuda, B, G, D, K):
    """The wide instantiation: G query rows over one head whose pool is
    both k and v (MLA's latent), D = Dv up to 320, MLA's scale; an
    all-invalid row gives 0.  A cur_len one block short must fail the
    tolerance."""
    bs, NB = 32, 80
    q, pool, _, idx, valid = _decode_inputs(cuda, G + D, B, G, 1, D, NB, bs,
                                            K)
    cur_len = torch.randint(NB * bs // 2, NB * bs, (B,),
                            generator=_gen(cuda, K), device=cuda,
                            dtype=torch.int32)
    valid[:, :, :2] = True
    valid[-1, -1] = B == 1           # an all-invalid row where B > 1
    args = (q, pool, pool, idx, valid, cur_len, MLA_SCALE)
    got = ops.sparse_decode_attention(*args)
    want = ref.sparse_decode_attention(*args)
    assert got.shape == (B, G, D)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=1e-2)
    if B > 1:
        assert not got[-1].any()
    short = ops.sparse_decode_attention(q, pool, pool, idx, valid,
                                        cur_len - NB * bs // 2, MLA_SCALE)
    assert not torch.allclose(short.float(), want.float(), atol=2e-3,
                              rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,D,NB,top_k", [
    (4, 40, 288, 256, 64),      # minicpm3's decode step, rank-all path
    (2, 40, 288, 1025, 64),     # its 32,768-token cap, radix path
    (1, 16, 320, 600, 64),      # the widest D the wide kernel takes
])
def test_mla_score_select_matches_plain(cuda, B, Hq, D, NB, top_k):
    """score_select over latent metadata (one head, D up to 320), held
    tie-aware as above; the planted fault (cur_len without the step's
    +1) must fail the check."""
    q, meta, cur_len = _select_case(cuda, B, Hq, 1, D, NB, 32)
    kw = dict(block_size=32, top_k=top_k, sink_blocks=1, recent_blocks=2)
    want = ref.score_select(q, meta, cur_len, **kw)
    s_ref = ref.select_scores(ref.block_score(q, meta), cur_len + 1,
                              block_size=32, sink_blocks=1, recent_blocks=2)
    assert _select_agrees(*ops.score_select(q, meta, cur_len, **kw), *want,
                          s_ref)
    assert not _select_agrees(*ops.score_select(q, meta, cur_len - 1, **kw),
                              *want, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Sq", [(40, 300), (4, 1000), (2, 130)])
def test_flash_prefill_mla_matches_plain(cuda, H, Sq):
    """q and k of depth 96, v of width 64, H heads over H (MLA's prefill),
    passed unpadded: the kernel reads the depth as two 64-column boxes,
    the second zero-filled past column 96.  Two planted faults (q_offset
    one too large, the last key dropped) must fail the tolerance."""
    g = _gen(cuda, H + Sq)
    q = torch.randn((1, Sq, H, 96), generator=g, device=cuda).bfloat16()
    k = torch.randn((1, Sq, H, 96), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, Sq, H, 64), generator=g, device=cuda).bfloat16()
    kw = dict(scale=MLA_SCALE)
    got = ops.flash_prefill(q, k, v, **kw)
    assert got.shape == (1, Sq, H, 64)
    assert _flash_close(got, q, k, v, **kw)
    kp, vp = _probe(q, k, v, 0, 1, MLA_SCALE)
    assert not _flash_close(ops.flash_prefill(q, kp, vp, q_offset=1, **kw),
                            q, kp, vp, **kw)
    kp, vp = _probe(q, k, v, Sq - 1, Sq - 1, MLA_SCALE)
    assert not _flash_close(ops.flash_prefill(
        q, kp[:, :-1].contiguous(), vp[:, :-1].contiguous(), **kw), q, kp,
        vp, **kw)


def _numpy_inputs(dev, seed, *shapes):
    import numpy as np
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s, dtype=np.float32)).to(
        dev).bfloat16() for s in shapes]


def _digest(t) -> str:
    import hashlib
    return hashlib.sha1(t.cpu().view(torch.int16).numpy().tobytes()
                        ).hexdigest()[:16]


# flash_prefill's output digests on _numpy_inputs(seed 0): (B, Sq, Hq, Hkv,
# D, q_offset) -> the earlier kernel's digest
FLASH_DIGESTS = {
    (1, 1000, 14, 2, 64, 0): "22a6919ba03ba8a6",
    (2, 300, 32, 8, 128, 200): "475a98e04a34b63e",
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_DIGESTS))
def test_flash_prefill_d_eq_dv_unchanged(cuda, case):
    """D = Dv in {64, 128}: the output equals the earlier kernel's bit for
    bit (its digest), and stays within the tolerance of the plain
    version."""
    B, Sq, Hq, Hkv, D, q_off = case
    q, k, v = _numpy_inputs(cuda, 0, (B, Sq, Hq, D),
                            (B, q_off + Sq, Hkv, D), (B, q_off + Sq, Hkv, D))
    kw = dict(scale=D ** -0.5, q_offset=q_off)
    got = ops.flash_prefill(q, k, v, **kw)
    assert _flash_close(got, q, k, v, **kw)
    assert _digest(got) == FLASH_DIGESTS[case]


@pytest.mark.gpu
def test_slice9_wrappers_raise_beyond_their_limits(cuda):
    """score_select takes D <= 320 (D % 4 == 0); flash_prefill the (D, Dv)
    pairs it is built for; block_score D <= 320 since its wide instance
    (MLA's context-parallel scoring).  Just past each limit the wrapper
    raises."""
    bf = torch.bfloat16
    cur = torch.full((1,), 40, device=cuda, dtype=torch.int32)
    kw = dict(block_size=32, top_k=64, sink_blocks=1, recent_blocks=2)
    q = torch.zeros((1, 40, 324), device=cuda, dtype=bf)
    meta = torch.zeros((1, 1, 8, 2, 324), device=cuda)
    with pytest.raises(ValueError, match="D <= 320"):
        ops.score_select(q, meta, cur, **kw)
    q = torch.zeros((1, 40, 324), device=cuda, dtype=bf)
    meta = torch.zeros((1, 1, 8, 2, 324), device=cuda)
    with pytest.raises(ValueError, match="D <= 320"):
        ops.block_score(q, meta)
    for D, Dv in ((96, 96), (96, 128), (80, 64), (112, 64)):
        fq = torch.zeros((1, 8, 2, D), device=cuda, dtype=bf)
        fv = torch.zeros((1, 8, 2, Dv), device=cuda, dtype=bf)
        with pytest.raises(ValueError, match="D, Dv"):
            ops.flash_prefill(fq, fq, fv, scale=1.0)
    # the decode attention's shared memory at D 320 with 128-token blocks
    q = torch.zeros((1, 16, 320), device=cuda, dtype=bf)
    pool = torch.zeros((1, 1, 2, 128, 320), device=cuda, dtype=bf)
    idx = torch.zeros((1, 1, 2), device=cuda, dtype=torch.int32)
    valid = torch.ones((1, 1, 2), device=cuda, dtype=torch.bool)
    with pytest.raises(ValueError, match="shared memory"):
        ops.sparse_decode_attention(q, pool, pool, idx, valid, cur)


# ---------------------------------------------------------------------------
# The MoE family (kimi-k2-1t-a32b, arctic-480b): flash_prefill at D = Dv =
# 112 (kimi-k2's 7168 / 64 heads), the decode kernels at kimi-k2's (G 8,
# D 112) and arctic-480b's (G 7, D 128)
# ---------------------------------------------------------------------------
# Tolerances as above.

def _flash_d112_inputs(dev, B, Sq, Sk, Hq, Hkv, seed):
    g = _gen(dev, seed)
    return [torch.randn((B, S, H, 112), generator=g, device=dev).bfloat16()
            for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv", [(64, 8), (16, 2)])
@pytest.mark.parametrize("Sq,q_offset", [(300, 0), (130, 70), (1000, 1000)])
def test_flash_prefill_d112_matches_plain(cuda, Hq, Hkv, Sq, q_offset):
    """D = Dv = 112: q, k and v each read as two 64-column boxes (the
    second zero-filled past column 112), P V at 128 columns, 112 stored;
    Sq not a multiple of 128, and chunk continuations.  Three planted
    faults must fail the tolerance: q_offset one too large, the last key
    dropped, and a store that spills 16 columns into the next head (the
    accumulator's zero columns 112-127 over that head's first 16)."""
    B, Sk, scale = 2, q_offset + Sq, 112 ** -0.5
    q, k, v = _flash_d112_inputs(cuda, B, Sq, Sk, Hq, Hkv, Sq + q_offset)
    kw = dict(scale=scale, q_offset=q_offset)
    got = ops.flash_prefill(q, k, v, **kw)
    assert got.shape == (B, Sq, Hq, 112)
    assert _flash_close(got, q, k, v, **kw)
    spilled = got.clone()
    spilled[:, :, 1:, :16] = 0
    assert not _flash_close(spilled, q, k, v, **kw)
    kp, vp = _probe(q, k, v, 0, q_offset + 1, scale)
    assert not _flash_close(ops.flash_prefill(
        q, kp, vp, scale=scale, q_offset=q_offset + 1), q, kp, vp, **kw)
    kp, vp = _probe(q, k, v, Sq - 1, Sk - 1, scale)
    assert not _flash_close(ops.flash_prefill(
        q, kp[:, :-1].contiguous(), vp[:, :-1].contiguous(), **kw), q, kp,
        vp, **kw)


@pytest.mark.gpu
def test_flash_prefill_d112_stores_no_column_past_its_head(cuda):
    """The kernel launched into a buffer that holds its (B, Sq, Hq, 112)
    output and 64 guard elements after it, all set to a sentinel: every
    output element is written and within the tolerance, and the guard,
    where the last head's columns 112-127 would land, is untouched."""
    from repro_torch.kernels.build import LIBS
    B, Sq, Hq, Hkv, scale = 1, 200, 8, 2, 112 ** -0.5
    q, k, v = _flash_d112_inputs(cuda, B, Sq, Sq, Hq, Hkv, 11)
    n = B * Sq * Hq * 112
    buf = torch.full((n + 64,), 1000.0, dtype=torch.bfloat16, device=cuda)
    rc = LIBS.fn("flash_prefill")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), None, B,
        Sq, Sq, Hq, Hkv, 112, 112, 0, 1, scale,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    out = buf[:n].view(B, Sq, Hq, 112)
    assert not (out == 1000.0).any()
    assert _flash_close(out, q, k, v, scale=scale)
    assert (buf[n:] == 1000.0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,D", [(4, 64, 8, 112), (4, 56, 8, 128)])
def test_moe_decode_shapes_match_plain(cuda, B, Hq, Hkv, D):
    """kimi-k2's decode step (G 8 over 8 kv heads at D 112) and
    arctic-480b's (G 7 at D 128): the split-K attention (an all-invalid
    row gives 0; a cur_len one block short must fail the tolerance) and
    score_select (tie-aware; cur_len without the step's +1 must fail)."""
    bs, NB, K = 32, 448, 64
    q, kp, vp, idx, valid = _decode_inputs(cuda, D + Hq, B, Hq, Hkv, D, NB,
                                           bs, K)
    valid[:, :, :2] = True
    valid[0, 0] = False
    cur_len = torch.randint(NB * bs // 2, NB * bs, (B,),
                            generator=_gen(cuda, D), device=cuda,
                            dtype=torch.int32)
    got = ops.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    want = ref.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    assert got.shape == (B, Hq, D)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=1e-2)
    assert not got[0, :Hq // Hkv].any()
    short = ops.sparse_decode_attention(q, kp, vp, idx, valid,
                                        cur_len - NB * bs // 2)
    assert not torch.allclose(short.float(), want.float(), atol=2e-3,
                              rtol=1e-2)
    q, meta, cur_len = _select_case(cuda, B, Hq, Hkv, D, NB, bs)
    kw = dict(block_size=bs, top_k=K, sink_blocks=1, recent_blocks=2)
    want = ref.score_select(q, meta, cur_len, **kw)
    s_ref = ref.select_scores(ref.block_score(q, meta), cur_len + 1,
                              block_size=bs, sink_blocks=1, recent_blocks=2)
    assert _select_agrees(*ops.score_select(q, meta, cur_len, **kw), *want,
                          s_ref)
    assert not _select_agrees(*ops.score_select(q, meta, cur_len - 1, **kw),
                              *want, s_ref)


@pytest.mark.gpu
def test_moe_slice_wrappers_raise_beyond_their_limits(cuda):
    """flash_prefill takes (112, 112) and no other pair near it: v wider
    or narrower than 112, D 104 or 120 raise."""
    bf = torch.bfloat16
    for D, Dv in ((112, 128), (112, 96), (128, 112), (104, 104),
                  (120, 120)):
        fq = torch.zeros((1, 8, 2, D), device=cuda, dtype=bf)
        fv = torch.zeros((1, 8, 2, Dv), device=cuda, dtype=bf)
        with pytest.raises(ValueError, match="D, Dv"):
            ops.flash_prefill(fq, fq, fv, scale=1.0)
    # the non-causal mode takes the same (D, Dv) pairs, no other
    fq = torch.zeros((1, 8, 2, 112), device=cuda, dtype=bf)
    fv = torch.zeros((1, 8, 2, 128), device=cuda, dtype=bf)
    with pytest.raises(ValueError, match="D, Dv"):
        ops.flash_prefill(fq, fq, fv, scale=1.0, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (1, 1500, 1500, 12, 12, 64),     # whisper-small's encoder
    (4, 256, 1500, 12, 12, 64),      # its cross-attention from a window
    (4, 1, 1500, 12, 12, 64),        # and from one decode token per row
    (2, 300, 1000, 16, 8, 128),      # G 2 at D 128, Sk ragged
])
def test_flash_prefill_noncausal_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D):
    """The non-causal mode: every query over every key j < Sk (1500 = 11
    x 128 + 92: the ragged last tile masked), q_offset ignored.  Planted
    faults must fail the tolerance: the causal mask applied (query 0
    sees key 0 only), the last key dropped, the ragged tile dropped."""
    q, k, v = _numpy_inputs(cuda, Sq + Sk, (B, Sq, Hq, D), (B, Sk, Hkv, D),
                            (B, Sk, Hkv, D))
    kw = dict(scale=D ** -0.5, causal=False)
    got = ops.flash_prefill(q, k, v, **kw)
    assert got.shape == (B, Sq, Hq, D)
    assert _flash_close(got, q, k, v, **kw)
    assert torch.equal(ops.flash_prefill(q, k, v, q_offset=37, **kw), got)
    kp, vp = _probe(q, k, v, 0, Sk - 1, D ** -0.5)
    whole = Sk // 128 * 128 if Sk % 128 else Sk - 128
    for fault in (ops.flash_prefill(q, kp, vp, scale=D ** -0.5),
                  ops.flash_prefill(q, kp[:, :-1].contiguous(),
                                    vp[:, :-1].contiguous(), **kw),
                  ops.flash_prefill(q, kp[:, :whole].contiguous(),
                                    vp[:, :whole].contiguous(), **kw)):
        assert not _flash_close(fault, q, kp, vp, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,D", [(4, 16, 8, 128), (4, 12, 12, 64)])
def test_frontend_decode_shapes_match_plain(cuda, B, Hq, Hkv, D):
    """internvl2-2b's decode step (G 2 at D 128) and whisper-small's (G 1
    at D 64): the split-K attention (an all-invalid row gives 0; a
    cur_len one block short must fail the tolerance) and score_select
    (tie-aware; cur_len without the step's +1 must fail)."""
    bs, NB, K = 32, 264, 64
    q, kp, vp, idx, valid = _decode_inputs(cuda, D + Hq, B, Hq, Hkv, D, NB,
                                           bs, K)
    valid[:, :, :2] = True
    valid[0, 0] = False
    cur_len = torch.randint(NB * bs // 2, NB * bs, (B,),
                            generator=_gen(cuda, D), device=cuda,
                            dtype=torch.int32)
    got = ops.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    want = ref.sparse_decode_attention(q, kp, vp, idx, valid, cur_len)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=1e-2)
    assert not got[0, :Hq // Hkv].any()
    short = ops.sparse_decode_attention(q, kp, vp, idx, valid,
                                        cur_len - NB * bs // 2)
    assert not torch.allclose(short.float(), want.float(), atol=2e-3,
                              rtol=1e-2)
    q, meta, cur_len = _select_case(cuda, B, Hq, Hkv, D, NB, bs)
    kw = dict(block_size=bs, top_k=K, sink_blocks=1, recent_blocks=2)
    want = ref.score_select(q, meta, cur_len, **kw)
    s_ref = ref.select_scores(ref.block_score(q, meta), cur_len + 1,
                              block_size=bs, sink_blocks=1, recent_blocks=2)
    assert _select_agrees(*ops.score_select(q, meta, cur_len, **kw), *want,
                          s_ref)
    assert not _select_agrees(*ops.score_select(q, meta, cur_len - 1, **kw),
                              *want, s_ref)


@pytest.mark.gpu
def test_noncausal_wrapper_raises_beyond_its_limits(cuda):
    """A CUDA call the kernel cannot take still raises in the non-causal
    mode: (D, Dv) outside FLASH_DIMS, a head count that is no multiple
    of the kv heads, a non-contiguous k."""
    bf = torch.bfloat16
    for D, Dv in ((32, 32), (64, 128), (96, 96)):
        fq = torch.zeros((1, 8, 4, D), device=cuda, dtype=bf)
        fv = torch.zeros((1, 8, 4, Dv), device=cuda, dtype=bf)
        with pytest.raises(ValueError, match="D, Dv"):
            ops.flash_prefill(fq, fq, fv, scale=1.0, causal=False)
    q = torch.zeros((1, 1, 12, 64), device=cuda, dtype=bf)
    kv = torch.zeros((1, 1500, 8, 64), device=cuda, dtype=bf)
    with pytest.raises(ValueError):
        ops.flash_prefill(q, kv, kv, scale=1.0, causal=False)
    kv = torch.zeros((1, 12, 1500, 64), device=cuda, dtype=bf)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_prefill(q, kv.transpose(1, 2), kv.transpose(1, 2),
                          scale=1.0, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,di", [(3, 150, 96), (2, 1, 64), (2, 70, 40),
                                     (1, 333, 64)])
def test_selective_scan_matches_plain(cuda, Bn, S, di):
    """selective_scan against its plain version (float32 on both sides:
    1e-5 + 1e-4 relative, as chip_smoke.py holds it) over right-padded
    rows (dt = 0 from S // 2, inside a staged 64-token chunk) from a
    non-zero h0: across more staged chunks than the kernel's two
    buffers, the decode step (S = 1), a channel count that leaves a CTA
    part-filled, and one row over several chunks with a part-filled last
    one; a kernel given no h0 must fail that.  The kernel takes bf16 x, B
    and C only, and a d_inner that is a multiple of 8."""
    g = _gen(cuda)
    bf16 = torch.bfloat16
    x = torch.randn((Bn, S, di), generator=g, device=cuda).to(bf16)
    dt = torch.nn.functional.softplus(
        torch.randn((Bn, S, di), generator=g, device=cuda) - 2)
    dt[0, S // 2:] = 0
    B, C = (torch.randn((Bn, S, 16), generator=g, device=cuda).to(bf16)
            for _ in range(2))
    A = -torch.rand((di, 16), generator=g, device=cuda) * 4
    D = torch.randn((di,), generator=g, device=cuda)
    h0 = torch.randn((Bn, di, 16), generator=g, device=cuda)
    want = ref.selective_scan(x, dt, B, C, A, D, h0)
    got = ops.selective_scan(x, dt, B, C, A, D, h0)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=1e-5, rtol=1e-4)
    bad = ops.selective_scan(x, dt, B, C, A, D, torch.zeros_like(h0))
    assert not torch.allclose(bad[0], want[0], atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError):
        ops.selective_scan(x, dt.double(), B, C, A, D, h0)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.selective_scan(x.float(), dt, B.float(), C.float(), A, D, h0)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.selective_scan(*(t[..., :di - 4].contiguous()
                             for t in (x, dt)), B, C,
                           A[:di - 4].contiguous(), D[:di - 4].contiguous(),
                           h0[:, :di - 4].contiguous())


# ---------------------------------------------------------------------------
# slice 13: score_select's other scorings; RWKV6's WKV recurrence
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("metadata,reduce", [("mean", "max"),
                                             ("cuboid", "sum"),
                                             ("mean", "sum")])
@pytest.mark.parametrize("B,Hq,Hkv,D,NB", [(4, 14, 2, 64, 136),
                                           (2, 32, 8, 128, 4097),
                                           (1, 40, 1, 288, 300)])
def test_score_select_other_scorings_match_plain(cuda, metadata, reduce, B,
                                                 Hq, Hkv, D, NB):
    """score_select with InfLLM's mean metadata ((B, Hkv, NB, D), q .
    mean) and with the sum over the GQA group, against the plain
    composition, tie-aware (mean rows 5-8 tied with row 4), on the narrow
    and the wide instantiation and the radix path; the kernel given the
    other reduction must fail the check."""
    bs = 32
    q, meta, cur_len = _select_case(cuda, B, Hq, Hkv, D, NB, bs, seed=5)
    if metadata == "mean":
        meta = meta[:, :, :, 1].contiguous()        # (B, Hkv, NB, D), tied
    kw = dict(block_size=bs, top_k=64, sink_blocks=1, recent_blocks=2,
              metadata=metadata, group_reduce=reduce)
    want = ref.score_select(q, meta, cur_len, **kw)
    s_ref = ref.select_scores(ref.block_score(q, meta, metadata, reduce),
                              cur_len + 1, block_size=bs, sink_blocks=1,
                              recent_blocks=2)
    ops.launches.reset()
    got = ops.score_select(q, meta, cur_len, **kw)
    assert ops.launches.counts["score_select"] == 1
    assert ops.launches.counts[
        f"score_select:{'sum' if reduce == 'sum' else 'mean'}"] == 1
    assert _select_agrees(*got, *want, s_ref)
    other = ops.score_select(q, meta, cur_len, **dict(
        kw, group_reduce="max" if reduce == "sum" else "sum"))
    assert not _select_agrees(*other, *want, s_ref)


def _wkv_case(dev, Bn, S, H, lens, seed=0):
    g = _gen(dev, seed)
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])[..., None, None]
    r, k, v = (torch.randn((Bn, S, H, 64), generator=g, device=dev)
               .bfloat16() for _ in range(3))
    k = (k * mask).contiguous()
    w = torch.where(mask, torch.exp(-torch.exp(torch.randn(
        (Bn, S, H, 64), generator=g, device=dev) - 2)), 1.0).contiguous()
    u = 0.1 * torch.randn((H, 64), generator=g, device=dev)
    S0 = torch.randn((Bn, H, 64, 64), generator=g, device=dev)
    return r, k, v, w, u, S0


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,H,lens", [
    (3, 150, 4, (150, 70, 1)),     # padded rows, 10 stages, time chunks
    (4, 1, 32, (1, 1, 1, 1)),      # the decode step
    (2, 33, 2, (33, 33)),          # a part-filled stage, one pass
    (1, 600, 2, (600,)),           # one row over chunks, the last part-filled
    (2, 300, 2, (300, 100))])      # padding across chunk edges
def test_wkv6_matches_plain(cuda, Bn, S, H, lens):
    """wkv6 against its plain version, float32 on both sides, per element
    within 2^-14 of the plain version on the inputs' magnitudes (as
    chip_smoke.py holds it), from a carried state over right-padded rows
    (k = 0, w = 1), in one pass and in time chunks (``ops.wkv6_chunk``);
    a kernel given no state, or no bonus, must fail that."""
    L = ops.wkv6_chunk(Bn, S, H, ops._sm_count(cuda))
    if S >= 300:
        # the chunked path, a length that is no multiple of the chunk, and
        # padding, where there is some, from before a chunk's edge to S
        assert S > L and S % L
        assert min(lens) == S or min(lens) // L < (S - 1) // L
    args = _wkv_case(cuda, Bn, S, H, lens)
    r, k, v, w, u, S0 = args
    weight = ref.wkv6(r.abs(), k.abs(), v.abs(), w, u.abs(), S0.abs())
    want = ref.wkv6(*args)

    def close(got):
        return all(bool(((a - b).abs() <= 2.0 ** -14 * m + 1e-6).all())
                   for a, b, m in zip(got, want, weight))
    ops.launches.reset()
    assert close(ops.wkv6(*args))
    assert ops.launches.counts["wkv6"] == 1
    assert not close(ops.wkv6(r, k, v, w, u, torch.zeros_like(S0)))
    assert not close(ops.wkv6(r, k, v, w, torch.zeros_like(u), S0))
    with pytest.raises(ValueError, match="head width"):
        ops.wkv6(*(a[..., :32].contiguous() for a in (r, k, v, w)),
                 u[:, :32].contiguous(), S0[..., :32, :32].contiguous())
    with pytest.raises(ValueError):
        ops.wkv6(r, k, v, w.double(), u, S0)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.wkv6(r.float(), k.float(), v.float(), w, u, S0)


def _bwd_case(dev, Bn, S, Hq, Hkv, D, seed=0):
    g = _gen(dev, seed)
    q, k, v, do = (torch.randn((Bn, S, h, D), generator=g, device=dev)
                   .bfloat16() for h in (Hq, Hkv, Hkv, Hq))
    return q, k, v, do


def _grad_close(got, want):
    """Within 2e-2 of the plain version's max |grad| and a cosine of at
    least 0.999 (the kernels round P and dS to bf16 before their products,
    as the forward rounds P); a gradient the plain version gives as
    exactly 0 within 1e-5."""
    g, w = got.float().flatten(), want.float().flatten()
    if not w.any():
        # a gradient that vanishes exactly (one key: dS = P (dP - Delta) =
        # 0), held to float32 rounding of order-1 products
        return g.abs().max().item() <= 1e-5
    err = (g - w).abs().max().item() / w.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
    return err <= 2e-2 and cos >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,Hq,Hkv,D", [(2, 200, 14, 2, 64),
                                           (1, 257, 32, 8, 128),
                                           (2, 64, 4, 4, 64),
                                           (1, 1, 7, 1, 128),
                                           (1, 130, 8, 1, 128),
                                           (2, 1000, 14, 2, 64),
                                           (1, 300, 7, 1, 128)])
def test_flash_prefill_bwd_matches_plain(cuda, Bn, S, Hq, Hkv, D):
    """The forward's lse within 1e-3 and its output bit for bit the serve
    launch's; dq, dk, dv against the plain backward on the same
    bf16-rounded inputs; two launches give the same bits; one count a
    call.  The cases: lengths ragged against the 128-key and 64- or
    128-query tiles (1000, 300, 257, 130), S below one tile, G 1, G 4 at
    D 128 (llama3-8b's), an odd G split into chunks (7, arctic-like)."""
    q, k, v, do = _bwd_case(cuda, Bn, S, Hq, Hkv, D)
    scale = D ** -0.5
    ops.launches.reset()
    o, lse = ops.flash_prefill_fwd_lse(q, k, v, scale=scale)
    assert torch.equal(o, ops.flash_prefill(q, k, v, scale=scale))
    po, plse = ref.flash_prefill_fwd_lse(q, k, v, scale=scale)
    assert (lse - plse).abs().max().item() <= 1e-3
    got = ops.flash_prefill_bwd(q, k, v, o, lse, do, scale=scale)
    again = ops.flash_prefill_bwd(q, k, v, o, lse, do, scale=scale)
    assert ops.launches.counts["flash_prefill_bwd"] == 2
    assert ops.launches.counts["flash_prefill:lse"] == 1
    want = ref.flash_prefill_bwd(q, k, v, o, lse, do, scale)
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert torch.equal(a, b)
        assert _grad_close(a, w)
    # a kernel that drops the group's sum (dK of the first head only)
    # must fail the bar where the group has more than one head
    if Hq > Hkv and S > 1:
        assert not _grad_close(got[1] * (Hkv / Hq), want[1])
    # and one that leaves the last chunk's partial dK and dV out of the
    # sum: the kernels' own result with that chunk's dO zeroed (its P^T
    # dO and dS^T Q vanish); a chunk is one head of each group
    G = Hq // Hkv
    if G > 1:
        drop = do.clone()
        drop[:, :, G - 1::G] = 0
        _, dk, dv = ops.flash_prefill_bwd(q, k, v, o, lse, drop,
                                          scale=scale)
        assert not (_grad_close(dk, want[1]) and _grad_close(dv, want[2]))


@pytest.mark.gpu
def test_flash_prefill_fn_trains_float32_through_the_kernels(cuda):
    """float32 q, k, v requiring grad (the trainer's activations): the
    forward runs the kernel in bf16, the output and the gradients come
    back in float32, against torch autograd of the plain version on the
    bf16-rounded inputs."""
    q, k, v, do = (t.float() for t in _bwd_case(cuda, 2, 300, 14, 2, 64, 1))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    ops.launches.reset()
    out = ops.flash_prefill(tq, tk, tv, scale=0.125)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, (tq, tk, tv), do)
    assert ops.launches.counts["flash_prefill:lse"] == 1
    assert ops.launches.counts["flash_prefill_bwd"] == 1
    with torch.no_grad():       # the Function alone, as an eval calls it
        assert torch.equal(ops.FlashPrefillFn.apply(q, k, v, 0.125, True),
                           out.detach())
    want = ref.flash_prefill_bwd(q, k, v, *ref.flash_prefill_fwd_lse(
        q, k, v, scale=0.125), do, 0.125)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and _grad_close(a, w)


@pytest.mark.gpu
def test_eval_step_runs_a_bfloat16_copy_on_the_card(cuda):
    """make_eval_step on the card: the kernels take bfloat16, so the step
    evaluates float32 weights in bfloat16 (each layer's copy made as the
    forward reaches it); its loss within 2e-2 relative of the float32
    loss on the CPU (bf16 products over 2 layers), and the float32
    weights untouched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.trainer import make_eval_step
    cfg = get_smoke_config("qwen2-0.5b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    want = make_eval_step(cfg)(params, batch).item()
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    card_params = tree_map(lambda t: t.to(cuda), params)
    ops.launches.reset()
    got = make_eval_step(cfg)(card_params, on_card).item()
    assert ops.launches.counts["flash_prefill"] == cfg.num_layers
    assert abs(got - want) <= 2e-2 * abs(want)
    assert card_params["embed"].dtype == torch.float32


@pytest.mark.gpu
def test_flash_prefill_bwd_raises_beyond_its_limits(cuda):
    x = torch.zeros((1, 64, 4, 64), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training step 5"):
        ops.flash_prefill(x, x[:, :32], x[:, :32], scale=0.125)
    with pytest.raises(NotImplementedError, match="training step 5"):
        ops.flash_prefill(x, x, x, scale=0.125, q_offset=4)
    # kimi-k2's (112, 112) trains; heads no config of the registry has
    # do not
    y = torch.zeros((1, 64, 4, 80), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="other heads"):
        ops.flash_prefill(y, y, y, scale=0.125)
    # the non-causal mode is built at Whisper's heads only
    z = torch.zeros((1, 64, 4, 128), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="non-causal"):
        ops.flash_prefill(z, z, z, scale=0.125, causal=False)


def _bwd_cross_case(dev, Bn, Sq, Sk, Hq, Hkv, D, Dv, seed=0):
    g = _gen(dev, seed)
    return tuple(torch.randn(shape, generator=g, device=dev).bfloat16()
                 for shape in ((Bn, Sq, Hq, D), (Bn, Sk, Hkv, D),
                               (Bn, Sk, Hkv, Dv), (Bn, Sq, Hq, Dv)))


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,Sq,Sk,Hq,Hkv,D,Dv,causal", [
    (1, 4096, 4096, 40, 40, 96, 64, True),     # minicpm3-4b's training
    (2, 300, 300, 6, 6, 96, 64, True),         # MLA, ragged
    (1, 257, 257, 8, 2, 96, 64, True),         # MLA's heads in a group
    (8, 1500, 1500, 12, 12, 64, 64, False),    # whisper-small's encoder
    (8, 448, 1500, 12, 12, 64, 64, False),     # its cross-attention
    (2, 448, 16, 12, 12, 64, 64, False),       # the launcher's 16 frames
    (2, 300, 700, 8, 2, 64, 64, False),        # a GQA group, non-causal
    (1, 1, 130, 4, 4, 64, 64, False)])         # one query row
def test_flash_prefill_bwd_training_instances_match_plain(
        cuda, Bn, Sq, Sk, Hq, Hkv, D, Dv, causal):
    """MLA's (96, 64) instances and the non-causal mode (Sq != Sk, keys
    and queries ragged against the tiles: 1500 = 11 x 128 + 92, 448 = 3 x
    128 + 64) of the forward with lse and the backward against their
    plain versions on the same bf16 inputs: lse within 1e-3, the output
    bit for bit the serve launch's, dq, dk, dv within the bar, two
    launches bit-equal, the counts under their labels.  A backward that
    left the ragged last key tile out (the plain one over the keys before
    it) must fail the bar."""
    q, k, v, do = _bwd_cross_case(cuda, Bn, Sq, Sk, Hq, Hkv, D, Dv)
    scale = D ** -0.5
    kw = dict(scale=scale, causal=causal)
    ops.launches.reset()
    o, lse = ops.flash_prefill_fwd_lse(q, k, v, **kw)
    assert torch.equal(o, ops.flash_prefill(q, k, v, **kw))
    _, plse = ref.flash_prefill_fwd_lse(q, k, v, **kw)
    assert (lse - plse).abs().max().item() <= 1e-3
    got = ops.flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    mode = "mla" if D == 96 else "noncausal"
    assert ops.launches.counts["flash_prefill_bwd"] == 2
    assert ops.launches.counts[f"flash_prefill_bwd:{mode}"] == 2
    assert ops.launches.counts[f"flash_prefill:lse_{mode}"] == 1
    want = ref.flash_prefill_bwd(q, k, v, o, lse, do, scale, causal)
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert torch.equal(a, b)
        assert _grad_close(a, w)
    if not causal and Sk > 128 and Sk % 128 >= 16:
        cut = Sk // 128 * 128
        short = ref.flash_prefill_bwd(q, k[:, :cut].contiguous(),
                                      v[:, :cut].contiguous(), o, lse, do,
                                      scale, causal)
        assert not _grad_close(got[0], short[0])


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,D,Dv,causal", [
    (300, 300, 6, 96, 64, True), (100, 700, 4, 64, 64, False)])
def test_flash_prefill_fn_trains_mla_and_noncausal(cuda, Sq, Sk, H, D, Dv,
                                                   causal):
    """``FlashPrefillFn`` on float32 activations at MLA's heads and in the
    non-causal mode over Sq != Sk: gradients in float32 against the plain
    backward on the bf16-rounded inputs, one launch of each kernel."""
    q, k, v, do = (t.float() for t in _bwd_cross_case(
        cuda, 2, Sq, Sk, H, H, D, Dv, 1))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    ops.launches.reset()
    out = ops.flash_prefill(tq, tk, tv, scale=0.125, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), do)
    assert ops.launches.counts["flash_prefill:lse"] == 1
    assert ops.launches.counts["flash_prefill_bwd"] == 1
    want = ref.flash_prefill_bwd(q, k, v, *ref.flash_prefill_fwd_lse(
        q, k, v, scale=0.125, causal=causal), do, 0.125, causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and _grad_close(a, w)


# ---------------------------------------------------------------------------
# RWKV6 training: wkv6's float32 forward (kernel A) and wkv6_bwd (kernel B)
# ---------------------------------------------------------------------------

# each gradient within 2^-12 of the plain version's max |grad| with a
# cosine >= 0.99999: float32 on both sides, reordered only by the chunk
# carries and the decay's suffix sum (as chip_smoke.py holds kernel B)
WKV_GRAD_ERR, WKV_GRAD_COS = 2.0 ** -12, 0.99999
WKV_TRAIN_CASES = [
    (2, 40, 2, (40, 40)),           # one chunk
    (1, 600, 2, (600,)),            # many chunks, a ragged tail
    (3, 300, 4, (300, 170, 1)),     # padding across chunk edges
    (2, 1000, 32, (1000, 1000)),    # rwkv6-1.6b's heads
    # kernel B stages 16 tokens: one chunk of 45 whose suffix starts from
    # a_end = <dS, S_end>, and chunks of 64 whose last (13) ends mid-stage
    (1, 45, 2, (45,)),
    (1, 333, 4, (333,))]


def _wkv_train_case(dev, Bn, S, H, lens, seed=0):
    """_wkv_case's operands with r, k, v float32 (the training
    precision), and dy, dS ~ N(0, 1)."""
    r, k, v, w, u, S0 = _wkv_case(dev, Bn, S, H, lens, seed)
    g = _gen(dev, seed + 1)
    dy = torch.randn((Bn, S, H, 64), generator=g, device=dev)
    dS = torch.randn((Bn, H, 64, 64), generator=g, device=dev)
    return (r.float(), k.float(), v.float(), w, u, S0, dy, dS)


def _wkv_grads_close(got, want):
    return all(
        (g - x).abs().max().item() <= WKV_GRAD_ERR * x.abs().max().item()
        and torch.nn.functional.cosine_similarity(
            g.flatten(), x.flatten(), dim=0).item() >= WKV_GRAD_COS
        for g, x in zip(got, want))


def _chunk_states(r, k, v, w, u, S0, L, nc):
    """The plain chunked forward's state before each of nc chunks of L."""
    states = [S0]
    for c in range(nc - 1):
        sl = slice(c * L, (c + 1) * L)
        states.append(ref.wkv6(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u,
                               states[-1])[1])
    return torch.stack(states, dim=2)


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,H,lens", WKV_TRAIN_CASES)
def test_wkv6_train_forward_matches_plain(cuda, Bn, S, H, lens):
    """Kernel A (float32 r, k, v): y and the final state against the
    token walk, and each chunk's S_in[c] against the plain chunked
    forward, per element within 2^-14 of the plain version on the inputs'
    magnitudes (wkv6's bar); one count under "wkv6" and "wkv6:train"."""
    r, k, v, w, u, S0, _, _ = _wkv_train_case(cuda, Bn, S, H, lens)
    L = ops.wkv6_chunk(Bn, S, H, ops._sm_count(cuda))
    nc = -(-S // L) if S > L else 1
    ops.launches.reset()
    y, S_fin, S_in = ops.wkv6_train(r, k, v, w, u, S0)
    assert ops.launches.counts["wkv6:train"] == 1
    assert S_in.shape == (Bn, H, nc, 64, 64)
    mags = (r.abs(), k.abs(), v.abs(), w, u.abs(), S0.abs())

    def close(got, want, weight):
        return bool(((got - want).abs() <= 2.0 ** -14 * weight + 1e-6).all())
    for got, want, weight in zip((y, S_fin), ref.wkv6(r, k, v, w, u, S0),
                                 ref.wkv6(*mags)):
        assert close(got, want, weight)
    assert close(S_in, _chunk_states(r, k, v, w, u, S0, L, nc),
                 _chunk_states(*mags, L, nc))


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,H,lens", WKV_TRAIN_CASES)
def test_wkv6_bwd_matches_plain(cuda, Bn, S, H, lens):
    """Kernel B's six gradients against ref.wkv6_bwd from S0 and dS
    non-zero, two launches bit-equal; planted faults must fail the bar:
    u's term dropped from dk, every chunk's suffix started from 0 instead
    of a_end (a build with that fault), and where the window has chunks
    lam's carry
    into chunk 0 dropped (the kernels on chunk 0's tokens alone, from dS
    = 0 at their end), the decay sum's carry into chunk 0 dropped (its
    <lam, S> at chunk 0's end, from the kernels on the tokens after it,
    taken out of chunk 0's dlogw)."""
    r, k, v, w, u, S0, dy, dS = _wkv_train_case(cuda, Bn, S, H, lens)
    _, _, S_in = ops.wkv6_train(r, k, v, w, u, S0)
    ops.launches.reset()
    got = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    again = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    assert ops.launches.counts["wkv6_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.wkv6_bwd(r, k, v, w, u, S0, dy, dS)
    assert _wkv_grads_close(got, want)
    bad = list(got)
    bad[1] = got[1] - r * u * (dy * v).sum(-1, keepdim=True)
    assert not _wkv_grads_close(bad, want)
    # every chunk's suffix from 0 (a_end left out): a planted build
    with ops.LIBS.planted("wkv6_bwd:no_aend"):
        bad = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    assert not _wkv_grads_close(bad, want)
    L = ops.wkv6_chunk(Bn, S, H, ops._sm_count(cuda))
    if S <= L:
        return
    head = tuple(t[:, :L].contiguous() for t in (r, k, v, w))
    _, _, s_head = ops.wkv6_train(*head, u, S0)
    g_head = ops.wkv6_bwd(*head, u, s_head, dy[:, :L].contiguous(),
                          torch.zeros_like(dS))
    bad = [t.clone() for t in got]
    for i in (1, 2, 3):
        bad[i][:, :L] = g_head[i]
    bad[5] = g_head[5]
    assert not _wkv_grads_close(bad, want)
    tail = tuple(t[:, L:].contiguous() for t in (r, k, v, w))
    s1 = S_in[:, :, 1].contiguous()
    _, _, s_tail = ops.wkv6_train(*tail, u, s1)
    lam1 = ops.wkv6_bwd(*tail, u, s_tail, dy[:, L:].contiguous(), dS)[5]
    bad = list(got)
    bad[3] = got[3].clone()
    bad[3][:, :L] -= (lam1 * s1).sum(-1)[:, None]
    assert not _wkv_grads_close(bad, want)


@pytest.mark.gpu
def test_wkv6_training_wrappers_raise_beyond_their_limits(cuda):
    r, k, v, w, u, S0, dy, dS = _wkv_train_case(cuda, 1, 300, 2, (300,))
    _, _, S_in = ops.wkv6_train(r, k, v, w, u, S0)
    with pytest.raises(ValueError, match="float32"):
        ops.wkv6_train(r.bfloat16(), k, v, w, u, S0)
    with pytest.raises(ValueError, match="float32"):
        ops.wkv6_bwd(r, k, v, w, u, S_in, dy.bfloat16(), dS)
    with pytest.raises(ValueError, match="head width"):
        ops.wkv6_bwd(*(t[..., :32].contiguous() for t in (r, k, v, w)),
                     u[:, :32].contiguous(),
                     S_in[..., :32, :32].contiguous(),
                     dy[..., :32].contiguous(),
                     dS[..., :32, :32].contiguous())
    with pytest.raises(ValueError, match="chunks"):
        ops.wkv6_bwd(r, k, v, w, u, S_in[:, :, :1].contiguous(), dy, dS)


@pytest.mark.gpu
def test_wkv6_fn_trains_through_the_kernels(cuda):
    """Wkv6Fn on the card: the forward through kernel A, the gradients of
    r, k, v, log w, u and S0 through kernel B, against ref.wkv6_bwd."""
    r, k, v, w, u, S0, dy, dS = _wkv_train_case(cuda, 2, 500, 4,
                                                (500, 321))
    leaves = [t.clone().requires_grad_()
              for t in (r, k, v, torch.log(w), u, S0)]
    ops.launches.reset()
    y, S_fin = ops.Wkv6Fn.apply(*leaves)
    got = torch.autograd.grad([y, S_fin], leaves, [dy, dS])
    assert ops.launches.counts["wkv6:train"] == 1
    assert ops.launches.counts["wkv6_bwd"] == 1
    assert _wkv_grads_close(got, ref.wkv6_bwd(r, k, v, torch.exp(
        torch.log(w)), u, S0, dy, dS))


@pytest.mark.gpu
def test_eval_step_runs_rwkv6_in_bfloat16_on_the_card(cuda):
    """make_eval_step at RWKV6's smoke on the card: the layers cast to
    bfloat16 but for the float32 leaves (the serve's wkv6 takes u in
    float32), the serve's wkv6 launched once a layer; the loss within
    2e-2 relative of the float32 loss on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.trainer import make_eval_step
    cfg = get_smoke_config("rwkv6-1.6b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    want = make_eval_step(cfg)(params, batch).item()
    ops.launches.reset()
    got = make_eval_step(cfg)(tree_map(lambda t: t.to(cuda), params),
                              {k: t.to(cuda) for k, t in batch.items()})
    assert ops.launches.counts["wkv6"] == cfg.num_layers
    assert ops.launches.counts.get("wkv6:train", 0) == 0
    assert abs(got.item() - want) <= 2e-2 * abs(want)


# --- training's selective scan (kernels C and D) and kimi-k2's (112, 112)
# training attention ---

SCAN_TRAIN_CASES = [(2, 300, 96, (300, 171)), (1, 64, 64, (64,)),
                    (3, 1, 40, (1, 1, 1)), (2, 1000, 512, (1000, 777)),
                    (1, 130, 8192, (130,)),
                    # 7 CTAs of 32 channels, the last one ragged, and a
                    # window ending mid-sub-chunk
                    (1, 100, 200, (100,))]


def _scan_train_case(dev, Bn, S, di, lens, seed=0):
    """Kernels C's and D's float32 operands as the Mamba layer's training
    hands them over: x, B, C ~ N(0, 1), dt = softplus(N(-2, 1)) zeroed
    past each row's length, A = -exp(log(1..16) + N(0, 0.1^2)), D = 1 +
    N(0, 0.1^2), h0, dy and dh ~ N(0, 1)."""
    g = _gen(dev, seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])
    dt = (torch.nn.functional.softplus(randn(Bn, S, di) - 2)
          * mask[..., None]).contiguous()
    A = -torch.exp(torch.arange(1, 17, device=dev).float().log()
                   + 0.1 * randn(di, 16))
    return (randn(Bn, S, di), dt, randn(Bn, S, 16), randn(Bn, S, 16), A,
            1 + 0.1 * randn(di), randn(Bn, di, 16), randn(Bn, S, di),
            randn(Bn, di, 16))


def _scan_grads_close(got, want):
    """chip_smoke.py's bar for kernel D: each gradient within 2^-12 of the
    plain version's max |grad| with a cosine >= 0.99999."""
    for g, w in zip(got, want):
        err = (g - w).abs().max().item() / w.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(
            g.flatten(), w.flatten(), dim=0).item()
        if err > 2.0 ** -12 or cos < 0.99999:
            return False
    return True


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,di,lens", SCAN_TRAIN_CASES)
def test_selective_scan_train_forward_matches_plain(cuda, Bn, S, di, lens):
    """Kernel C: y and the final state within the serve's bar (1e-5 +
    1e-4 |ref|), each checkpoint the plain state before its 64-token
    chunk within the same bar (chunk 0's h0 itself), one count under
    "selective_scan" and "selective_scan:train"."""
    x, dt, Bm, Cm, A, D, h0, _, _ = _scan_train_case(cuda, Bn, S, di, lens)
    ops.launches.reset()
    y, h, ckpt = ops.selective_scan_train(x, dt, Bm, Cm, A, D, h0)
    assert ops.launches.counts["selective_scan"] == 1
    assert ops.launches.counts["selective_scan:train"] == 1
    n_ck = -(-S // ops.SCAN_CHUNK)
    assert ckpt.shape == (Bn, n_ck, di, 16)
    assert torch.equal(ckpt[:, 0], h0)
    want_y, want_h = ref.selective_scan(x, dt, Bm, Cm, A, D, h0)
    states, hc = [h0], h0
    for c in range(1, n_ck):
        sl = slice((c - 1) * ops.SCAN_CHUNK, c * ops.SCAN_CHUNK)
        _, hc = ref.selective_scan(x[:, sl], dt[:, sl], Bm[:, sl],
                                   Cm[:, sl], A, D, hc)
        states.append(hc)
    for got, want in ((y, want_y), (h, want_h),
                      (ckpt, torch.stack(states, dim=1))):
        assert bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,di,lens", SCAN_TRAIN_CASES)
def test_selective_scan_bwd_matches_plain(cuda, Bn, S, di, lens):
    """Kernel D against ref.selective_scan_bwd on the same float32 inputs
    (its checkpoints from kernel C): dx, ddt, dB, dC, dA, dD and dh0
    within the bar, two launches bit-equal, one count a call; the bar
    rejects a kernel that ignores the final state's gradient, one rerun
    from a zeroed checkpoint where there are two chunks, and dB and dC
    without the second CTA's channels where there are any."""
    x, dt, Bm, Cm, A, D, h0, dy, dh = _scan_train_case(cuda, Bn, S, di,
                                                       lens)
    _, _, ckpt = ops.selective_scan_train(x, dt, Bm, Cm, A, D, h0)
    ops.launches.reset()
    got = ops.selective_scan_bwd(x, dt, Bm, Cm, A, D, ckpt, dy, dh)
    again = ops.selective_scan_bwd(x, dt, Bm, Cm, A, D, ckpt, dy, dh)
    assert ops.launches.counts["selective_scan_bwd"] == 2
    want = ref.selective_scan_bwd(x, dt, Bm, Cm, A, D, h0, dy, dh)
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert torch.equal(a, b)
    assert _scan_grads_close(got, want)
    bad = ops.selective_scan_bwd(x, dt, Bm, Cm, A, D, ckpt, dy,
                                 torch.zeros_like(dh))
    assert not _scan_grads_close(bad, want)
    if ckpt.shape[1] > 1:
        zeroed = ckpt.clone()
        zeroed[:, 1] = 0
        bad = ops.selective_scan_bwd(x, dt, Bm, Cm, A, D, zeroed, dy, dh)
        assert not _scan_grads_close(bad, want)
    if di > 32:
        # the second 32-channel CTA's share of dB and dC left out
        keep = torch.zeros_like(dt[0, 0])
        keep[32:64] = 1
        only = ops.selective_scan_bwd(x, (dt * keep).contiguous(), Bm, Cm,
                                      A, D, ckpt, (dy * keep).contiguous(),
                                      dh)
        bad = list(got)
        bad[2], bad[3] = got[2] - only[2], got[3] - only[3]
        assert not _scan_grads_close(bad, want)


@pytest.mark.gpu
def test_selective_scan_fn_trains_through_the_kernels(cuda):
    """SelectiveScanFn on the card: the forward through kernel C, the
    gradients of x, dt, B, C, A, D and h0 through kernel D, against
    ref.selective_scan_bwd; bfloat16 inputs come back as bfloat16
    gradients."""
    x, dt, Bm, Cm, A, D, h0, dy, dh = _scan_train_case(cuda, 2, 500, 128,
                                                       (500, 321))
    leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm, A, D, h0)]
    ops.launches.reset()
    y, h = ops.SelectiveScanFn.apply(*leaves)
    got = torch.autograd.grad([y, h], leaves, [dy, dh])
    assert ops.launches.counts["selective_scan:train"] == 1
    assert ops.launches.counts["selective_scan_bwd"] == 1
    assert _scan_grads_close(got, ref.selective_scan_bwd(
        x, dt, Bm, Cm, A, D, h0, dy, dh))
    xb = x.bfloat16().requires_grad_()
    y, _ = ops.SelectiveScanFn.apply(xb, dt, Bm, Cm, A, D, h0)
    assert torch.autograd.grad(y, xb, dy)[0].dtype == torch.bfloat16


@pytest.mark.gpu
def test_selective_scan_training_wrappers_raise_beyond_their_limits(cuda):
    x, dt, Bm, Cm, A, D, h0, dy, dh = _scan_train_case(cuda, 1, 200, 64,
                                                       (200,))
    _, _, ckpt = ops.selective_scan_train(x, dt, Bm, Cm, A, D, h0)
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan_train(x.bfloat16(), dt, Bm, Cm, A, D, h0)
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan_bwd(x, dt, Bm, Cm, A, D, ckpt, dy.bfloat16(), dh)
    with pytest.raises(ValueError, match="chunks"):
        ops.selective_scan_bwd(x, dt, Bm, Cm, A, D,
                               ckpt[:, :1].contiguous(), dy, dh)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.selective_scan_train(
            x[..., :60].contiguous(), dt[..., :60].contiguous(), Bm, Cm,
            A[:60].contiguous(), D[:60].contiguous(),
            h0[:, :60].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("Bn,S,Hq,Hkv", [(1, 4096, 64, 8), (2, 300, 16, 2),
                                         (1, 257, 8, 8)])
def test_flash_prefill_bwd_d112_matches_plain(cuda, Bn, S, Hq, Hkv):
    """kimi-k2's (112, 112) training instances (the lse forward, the
    backward with v and dO in two 64-column boxes, zero-filled past 112)
    against their plain versions: lse within 1e-3, the output bit for bit
    the serve launch's, dq, dk, dv within the bar, two launches
    bit-equal, the counts under "lse_d112" and "d112"."""
    q, k, v, do = _bwd_case(cuda, Bn, S, Hq, Hkv, 112)
    scale = 112 ** -0.5
    ops.launches.reset()
    o, lse = ops.flash_prefill_fwd_lse(q, k, v, scale=scale)
    assert torch.equal(o, ops.flash_prefill(q, k, v, scale=scale))
    _, plse = ref.flash_prefill_fwd_lse(q, k, v, scale=scale)
    assert (lse - plse).abs().max().item() <= 1e-3
    got = ops.flash_prefill_bwd(q, k, v, o, lse, do, scale=scale)
    again = ops.flash_prefill_bwd(q, k, v, o, lse, do, scale=scale)
    assert ops.launches.counts["flash_prefill_bwd:d112"] == 2
    assert ops.launches.counts["flash_prefill:lse_d112"] == 1
    want = ref.flash_prefill_bwd(q, k, v, o, lse, do, scale)
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape and torch.equal(a, b)
        assert _grad_close(a, w)
    # dV without its last 16 columns' products (dO's second box dropped)
    drop = do.clone()
    drop[..., 64:] = 0
    _, _, dv = ops.flash_prefill_bwd(q, k, v, o, lse, drop, scale=scale)
    assert not _grad_close(dv, want[2])


@pytest.mark.gpu
def test_jamba_float32_forward_without_grad_on_the_card(cuda):
    """forward_train in float32 under torch.no_grad() on the card at
    jamba's smoke widths in the full config's layer layout, so that its 2
    layers are the ones chip_smoke.py trains (Mamba with the dense FFN,
    Mamba with the MoE; an attention layer's bf16-only forward leaves a
    float32 forward with attention to the eval step's bf16 cast): each
    Mamba layer through the training scan (kernel C, the serve's
    bf16-only scan never), the loss within 1e-5 relative of the same
    forward on the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import tree_map
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              attn_layer_period=8, attn_layer_offset=4)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    with torch.no_grad():
        want = M.forward_train(params, cfg, batch)[0].item()
        ops.launches.reset()
        got = M.forward_train(tree_map(lambda t: t.to(cuda), params), cfg,
                              {k: t.to(cuda) for k, t in batch.items()})[0]
    assert [M.layer_kind(cfg, i) for i in range(cfg.num_layers)] == [
        "mamba", "mamba"] and cfg.is_moe_layer(1)
    assert ops.launches.counts["selective_scan:train"] == 2
    assert ops.launches.counts["selective_scan"] == 2
    assert abs(got.item() - want) <= 1e-5 * abs(want)


@pytest.mark.gpu
def test_eval_step_runs_jamba_in_bfloat16_on_the_card(cuda):
    """make_eval_step at jamba's smoke on the card: the layers cast to
    bfloat16 one at a time but for the float32 leaves (the router, dt_bias,
    A_log, D), the serve's selective_scan launched once a Mamba layer and
    the training instance never; the loss within 2e-2 relative of the
    float32 loss on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.trainer import make_eval_step
    cfg = get_smoke_config("jamba-v0.1-52b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    want = make_eval_step(cfg)(params, batch).item()
    ops.launches.reset()
    got = make_eval_step(cfg)(tree_map(lambda t: t.to(cuda), params),
                              {k: t.to(cuda) for k, t in batch.items()})
    n = sum(M.layer_kind(cfg, i) == "mamba" for i in range(cfg.num_layers))
    assert ops.launches.counts["selective_scan"] == n
    assert ops.launches.counts.get("selective_scan:train", 0) == 0
    assert abs(got.item() - want) <= 2e-2 * abs(want)


# kernel B where whole channels decay near 0 (w = exp(-exp(N(2, 0.5))),
# about 1e-3 and far below), beside channels drawn as usual: dlogw there is
# a difference of suffix sums far larger than itself, so each channel's
# dlogw is held against the float64 reverse loop on its own scale, a
# relative L2 over its tokens (the bar written before the first card run)
WKV_DLOGW_REL = 2.0 ** -8


@pytest.mark.gpu
def test_wkv6_bwd_near_zero_decays(cuda):
    r, k, v, w, u, S0, dy, dS = _wkv_train_case(cuda, 2, 1000, 4,
                                                (1000, 1000), seed=3)
    g = _gen(cuda, 4)
    w[:, :, 0, :16] = torch.exp(-torch.exp(
        2.0 + 0.5 * torch.randn((2, 1000, 16), generator=g, device=cuda)))
    _, _, S_in = ops.wkv6_train(r, k, v, w, u, S0)
    got = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    want = ref.wkv6_bwd(*(t.double() for t in (r, k, v, w, u, S0, dy, dS)))
    rel = (((got[3].double() - want[3]) ** 2).sum((0, 1)).sqrt()
           / (want[3] ** 2).sum((0, 1)).sqrt())
    assert float(rel.max()) <= WKV_DLOGW_REL, rel[0, :16]
    assert float(want[3][:, :, 0, :16].abs().mean()) < \
        1e-2 * float(want[3][:, :, 0, 16:].abs().mean())
    assert _wkv_grads_close([x for i, x in enumerate(got) if i != 3],
                            [x.float() for i, x in enumerate(want) if i != 3])


# ---------------------------------------------------------------------------
# The guarded dispatch window (device.dispatch_window)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_window_guard_raises_on_a_sync_on_the_dispatch_thread(cuda):
    from repro_torch.device import GUARD, SyncInDispatchWindow, \
        dispatch_window
    x = torch.ones(8, device=cuda)
    GUARD.reset()
    with pytest.raises(SyncInDispatchWindow):
        with dispatch_window(cuda):
            x.sum().item()
    with pytest.raises(SyncInDispatchWindow):
        with dispatch_window(cuda):
            x.cpu()
    assert GUARD.flagged >= 2
    # launches and pinned, non-blocking copies pass, and any sync when the
    # window is not armed
    GUARD.reset()
    pinned = torch.ones(8).pin_memory()
    with dispatch_window(cuda):
        y = x * 2
        y.copy_(pinned, non_blocking=True)
    with dispatch_window(cuda, armed=False):
        y.sum().item()
    assert GUARD.flagged == 0 and GUARD.windows == 1


@pytest.mark.gpu
def test_window_guard_is_silent_for_the_worker_thread(cuda):
    """The host stage worker waits for its copies while the dispatch
    thread is inside a window: those waits are legitimate."""
    from repro_torch.core.host_stage import HostStageWorker
    from repro_torch.device import GUARD, HostCopy, dispatch_window
    GUARD.reset()
    x = torch.randn((1 << 20,), device=cuda)
    worker = HostStageWorker(name="guard-test")
    try:
        with dispatch_window(cuda):
            for i in range(4):
                pending = HostCopy(x * i)
                worker.submit(i, lambda p=pending: (
                    p.wait(), torch.cuda.current_stream().synchronize()))
            worker.drain()
    finally:
        worker.close()
    assert GUARD.flagged == 0 and GUARD.windows == 1


@pytest.mark.gpu
def test_guarded_serve_gives_the_unguarded_serve(cuda, monkeypatch):
    """The default async serve with its windows armed gives the tokens and
    TransferStats of the same serve with the guard taken out, and its
    windows flag nothing."""
    import contextlib
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.device import GUARD
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving.request import Request
    cfg = get_smoke_config("qwen2-0.5b")
    params = M.init_params(cfg, _gen(cuda), torch.bfloat16, "cuda")

    def serve():
        eng = E.ServingEngine(params, cfg, E.EngineConfig(
            hbm_blocks_per_request=1, prefill_max_tokens_per_step=64))
        rng = np.random.default_rng(7)
        ids = []
        for p, t in zip((300, 200, 260), (0.0, 1e-4, 3e-3)):
            r = Request(prompt_len=p, max_new_tokens=6, arrival_time=t)
            eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                       .astype(np.int32))
            ids.append(r.req_id)
        eng.run()
        return ([eng.states[i].out_tokens for i in ids],
                dataclasses.asdict(eng.transfer_stats()))
    GUARD.reset()
    guarded = serve()
    assert GUARD.windows > 0 and GUARD.flagged == 0
    monkeypatch.setattr(E, "dispatch_window",
                        lambda device, armed=True: contextlib.nullcontext())
    assert serve() == guarded


# ---------------------------------------------------------------------------
# The context-parallel decode's kernels: the partial mode of the decode
# attention (a rank's block shard, local ids, validity at global
# positions through block_offset) and block_score's wide instance (MLA's
# 288-wide latent metadata)
# ---------------------------------------------------------------------------
# The partials are float32 sums the kernel takes in another order than
# the plain version (split runs merged by log-sum-exp): m within 1e-4 of
# the scores' scale, l and acc within 1e-4 of their scale plus 1e-4
# relative.


def _partial_close(got, want) -> bool:
    """(acc, m, l) within the tolerance above; m exactly -1e30 where the
    plain version's is (no valid position)."""
    ok = True
    for g, w in zip(got, want):
        empty = w <= -1e29
        ok &= bool((g[empty] == w[empty]).all())
        g, w = g[~empty], w[~empty]
        scale = w.abs().max().clamp(min=1e-30) if w.numel() else 0.0
        ok &= bool(((g - w).abs() <= 1e-4 * scale + 1e-4 * w.abs()).all())
    return ok


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hkv,G,D,K,offset", [
    (2, 8, 4, 128, 64, 256),    # llama3-8b's heads, rank 1 of 2 at NB 512
    (2, 1, 40, 288, 64, 256),   # minicpm3-4b's latent head (k = v)
    (3, 2, 7, 64, 13, 0),       # qwen2-0.5b's heads, rank 0
    (1, 1, 17, 320, 5, 3)])
def test_partial_decode_attention_matches_plain(cuda, B, Hkv, G, D, K,
                                                offset):
    """The partial mode against its plain version: local ids over a
    shard of NB blocks whose block 0 is global block ``offset``, cur_len
    global and cutting a block mid-way, a row whose shard holds no valid
    position (m = -1e30, l = 0, acc = 0 exactly, where rows remain).  The
    kernel given the offset one block off must fail the tolerance."""
    bs, NB = 32, 256 if D <= 128 else 160
    q, kp, vp, idx, valid = _decode_inputs(cuda, G + D + K, B, G * Hkv,
                                           Hkv, D, NB, bs, K)
    if Hkv == 1 and G >= 17:
        vp = kp                        # MLA: the latent is k and v
    lo, hi = offset * bs, (offset + NB) * bs
    cur_len = torch.randint(lo + bs, hi, (B,), generator=_gen(cuda, K),
                            device=cuda, dtype=torch.int32)
    if B > 1 and offset:
        cur_len[-1] = lo - 5           # this shard holds none of it
    # the shard's blocks of each row's last two positions selected, as
    # DSA's recent blocks are, so validity at wrong positions shows
    last = ((cur_len.long() - 1) // bs - offset).clamp(0, NB - 1)
    pick = torch.rand((B, Hkv, NB), generator=_gen(cuda, D), device=cuda)
    pick.scatter_(2, last[:, None, None].expand(B, Hkv, 1), 3.0)
    pick.scatter_(2, (last - 1).clamp(min=0)[:, None, None].expand(
        B, Hkv, 1), 2.0)
    idx = pick.argsort(-1, descending=True)[..., :K].int().contiguous()
    valid[:, :, :2] = True
    if B > 1 and not offset:
        valid[-1] = False              # shard 0: no valid selection
    scale = MLA_SCALE if vp is kp else None
    args = (q, kp, vp, idx, valid, cur_len, offset, scale)
    ops.launches.reset()
    got = ops.sparse_decode_attention_partial(*args)
    torch.cuda.synchronize()
    assert ops.launches.counts["sparse_decode_attention:partial"] == 1
    want = ref.sparse_decode_attention_partial(*args)
    assert [t.shape for t in got] == [(B, G * Hkv, vp.shape[-1]),
                                      (B, G * Hkv), (B, G * Hkv)]
    assert all(t.dtype == torch.float32 for t in got)
    assert _partial_close(got, want)
    if B > 1:
        assert (got[1][-1] == -1e30).all() and not got[2][-1].any() \
            and not got[0][-1].any()
    off = ops.sparse_decode_attention_partial(q, kp, vp, idx, valid,
                                              cur_len, offset + 1, scale)
    assert not _partial_close(off, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,D,NB", [(2, 40, 1, 288, 256),
                                           (3, 40, 1, 320, 37),
                                           (2, 17, 1, 136, 9),
                                           (2, 17, 1, 132, 9),
                                           (2, 32, 8, 128, 256)])
def test_block_score_wide_instance_matches_plain(cuda, B, Hq, Hkv, D, NB):
    """block_score past D = 128 (its wide instance, counted as
    "block_score:wide"): MLA's 288-wide latent metadata under G = 40,
    D 320 and an NB that leaves a ragged CTA, an odd G (the last head
    alone) with q rows staged 16 bytes a load (G * D % 8 == 0) and one
    by one (D 132); at D <= 128 the narrow instance, uncounted as wide.
    Tolerance as the narrow one's."""
    g = _gen(cuda, D + NB)
    q = torch.randn((B, Hq, D), generator=g, device=cuda).bfloat16()
    mn = torch.randn((B, Hkv, NB, D), generator=g, device=cuda)
    meta = torch.stack([mn, mn + torch.rand((B, Hkv, NB, D), generator=g,
                                            device=cuda)], dim=3)
    ops.launches.reset()
    got = ops.block_score(q, meta.contiguous())
    torch.cuda.synchronize()
    assert ops.launches.counts.get("block_score:wide", 0) == int(D > 128)
    torch.testing.assert_close(got, ref.block_score(q, meta), atol=1e-3,
                               rtol=1e-4)
