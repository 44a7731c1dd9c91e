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
                                         (7, 1, 32, 8)])
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
