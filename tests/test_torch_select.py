"""The decode select stage from q to the selected blocks,
``dsa.score_and_select`` (on the GPU the fused ``score_select`` kernel, on
the CPU its plain version), against the reference's
``select_blocks(block_score(q, min, max), cfg, cur_len + 1)`` on the same
numpy inputs made from a seed.

``torch.topk`` and ``jax.lax.top_k`` may order a selection, and choose
among tied scores at the K-th place, otherwise, so per (request, kv-head)
the test holds: ``sel_valid`` counts equal; the reference's scores of the
selected blocks equal as sorted lists (tie-aware: equal within the float32
score tolerance, atol/rtol 1e-5, sums taken in another order); and the id
sets equal wherever the K-th and (K+1)-th reference scores differ by more
than that tolerance.  Inputs carry forced score ties (repeated block
metadata) and a cur_len at a block edge (the step's +1 opens a new block).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsa as jdsa
from repro.kernels import ref as jref
from repro.models.common import DSAConfig as JDSA
from repro_torch.core import dsa as tdsa
from repro_torch.kernels import ops
from repro_torch.models.common import DSAConfig as TDSA

ATOL = RTOL = 1e-5
NEG_INF = -1e30


def _inputs(seed, B, Hkv, G, D, NB, bs):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hkv * G, D), dtype=np.float32)
    mn = r.standard_normal((B, Hkv, NB, D), dtype=np.float32)
    mx = mn + np.abs(r.standard_normal((B, Hkv, NB, D), dtype=np.float32))
    # forced ties: blocks 5-8 carry block 4's cuboid, block 11 block 2's
    mn[:, :, 5:9], mx[:, :, 5:9] = mn[:, :, 4:5], mx[:, :, 4:5]
    mn[:, :, 11], mx[:, :, 11] = mn[:, :, 2], mx[:, :, 2]
    meta = np.stack([mn, mx], axis=3)
    # tokens before this step: a block edge (the +1 opens block 9), one
    # short of an edge, mid-block, the whole pool, and a single token
    cur_len = np.asarray([9 * bs, 6 * bs - 1, 13 * bs + 5, NB * bs - 1, 0],
                         np.int32)[:B]
    return q, mn, mx, meta, cur_len


def _masked_scores(scores, cfg, n_tokens):
    """The reference's select-time scores: masked, sinks and recent blocks
    forced to +inf (numpy, as ``select_blocks`` builds them)."""
    B, Hkv, NB = scores.shape
    n_valid = -(-n_tokens // cfg.block_size)
    blk = np.arange(NB)
    valid = blk[None] < n_valid[:, None]
    s = np.where(valid[:, None], scores, NEG_INF).astype(np.float64)
    sink = blk[None] < np.minimum(cfg.sink_blocks, n_valid)[:, None]
    recent = blk[None] >= (n_valid - cfg.recent_blocks)[:, None]
    force = valid & (sink | (recent if cfg.recent_blocks > 0 else False))
    return np.where(force[:, None], np.inf, s)


def assert_same_selection(got_idx, got_valid, want_idx, want_valid, s_ref,
                          K):
    """Tie-aware selection equality per (request, kv-head); s_ref the
    reference's masked scores (B, Hkv, NB)."""
    B, Hkv, NB = s_ref.shape
    for b in range(B):
        for h in range(Hkv):
            gv, wv = got_valid[b, h], want_valid[b, h]
            assert gv.sum() == wv.sum(), (b, h)
            g_ids, w_ids = got_idx[b, h][gv], want_idx[b, h][wv]
            assert len(set(g_ids.tolist())) == len(g_ids), (b, h)
            np.testing.assert_allclose(np.sort(s_ref[b, h, g_ids]),
                                       np.sort(s_ref[b, h, w_ids]),
                                       atol=ATOL, rtol=RTOL)
            order = np.sort(s_ref[b, h])[::-1]
            if K < NB and not np.isclose(order[K - 1], order[K], atol=ATOL,
                                         rtol=RTOL):
                assert set(g_ids.tolist()) == set(w_ids.tolist()), (b, h)
            # invalid selections point at block 0
            assert not got_idx[b, h][~gv].any(), (b, h)


@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("sink,recent", [(0, 0), (1, 2), (2, 3)])
def test_score_and_select_matches_reference(G, D, sink, recent):
    B, Hkv, NB, bs, budget = 5, 2, 19, 8, 48          # K = 6 of 19
    q, mn, mx, meta, cur_len = _inputs(G * D + sink, B, Hkv, G, D, NB, bs)
    tcfg = TDSA(block_size=bs, token_budget=budget, sink_blocks=sink,
                recent_blocks=recent)
    jcfg = JDSA(block_size=bs, token_budget=budget, sink_blocks=sink,
                recent_blocks=recent)
    ops.launches.reset()
    ti, tv = tdsa.score_and_select(torch.from_numpy(q),
                                   torch.from_numpy(meta), tcfg,
                                   torch.from_numpy(cur_len))
    assert sum(ops.launches.counts.values()) == 0
    scores = jref.block_score(jnp.asarray(q), jnp.asarray(mn),
                              jnp.asarray(mx))
    ji, jv = jdsa.select_blocks(scores, jcfg, jnp.asarray(cur_len + 1))
    ji, jv = np.asarray(ji), np.asarray(jv)
    assert ti.dtype == torch.int32 and tv.dtype == torch.bool
    assert tuple(ti.shape) == ji.shape == (B, Hkv, tcfg.top_k_blocks)
    s_ref = _masked_scores(np.asarray(scores), tcfg, cur_len + 1)
    assert_same_selection(ti.numpy(), tv.numpy(), ji, jv, s_ref,
                          tcfg.top_k_blocks)


@pytest.mark.parametrize("NB,budget", [(3, 64), (19, 8 * 19)])
def test_score_and_select_k_at_least_nb(NB, budget):
    """K = min(top_k, NB): with K >= NB every valid block is selected and
    the rest are invalid, pointing at block 0."""
    B, Hkv, G, D, bs = 2, 2, 4, 64, 8
    q, mn, mx, meta, _ = _inputs(5, B, Hkv, G, D, 19, bs)
    meta, mn, mx = meta[:, :, :NB], mn[:, :, :NB], mx[:, :, :NB]
    cur_len = np.asarray([2 * bs - 1, 0], np.int32)
    tcfg = TDSA(block_size=bs, token_budget=budget)
    ti, tv = tdsa.score_and_select(torch.from_numpy(q),
                                   torch.from_numpy(meta.copy()), tcfg,
                                   torch.from_numpy(cur_len))
    assert tuple(ti.shape) == (B, Hkv, NB)
    assert tv[0].sum(-1).tolist() == [min(2, NB)] * Hkv
    assert tv[1].sum(-1).tolist() == [1] * Hkv
    assert not ti[~tv].any()
    ji, jv = jdsa.select_blocks(
        jref.block_score(jnp.asarray(q), jnp.asarray(mn), jnp.asarray(mx)),
        JDSA(block_size=bs, token_budget=budget), jnp.asarray(cur_len + 1))
    for b in range(B):
        for h in range(Hkv):
            assert set(ti[b, h][tv[b, h]].tolist()) == \
                set(np.asarray(ji)[b, h][np.asarray(jv)[b, h]].tolist())


@pytest.mark.parametrize("method,reduce", [("mean", "max"),
                                           ("cuboid", "sum")])
def test_score_and_select_other_scorings_are_the_plain_composition(
        method, reduce, monkeypatch):
    """Other metadata or reductions: the plain composition on the CPU,
    equal to the reference's; on any other device they reach the
    ``score_select`` wrapper with their scoring, as the cuboid/max case
    does (its kernel's mean and sum modes on the GPU), which raises for
    the ``meta`` device and counts no launch."""
    B, Hkv, G, D, NB, bs = 3, 2, 7, 32, 11, 8
    r = np.random.default_rng(8)
    q = r.standard_normal((B, Hkv * G, D), dtype=np.float32)
    shape = (B, Hkv, NB, 2, D) if method == "cuboid" else (B, Hkv, NB, D)
    meta = r.standard_normal(shape, dtype=np.float32)
    cur_len = np.asarray([3 * bs, 40, 1], np.int32)
    tcfg = TDSA(block_size=bs, token_budget=32, metadata=method)
    jcfg = JDSA(block_size=bs, token_budget=32, metadata=method)
    ti, tv = tdsa.score_and_select(torch.from_numpy(q),
                                   torch.from_numpy(meta), tcfg,
                                   torch.from_numpy(cur_len), reduce)
    scores = jdsa.score_blocks(jnp.asarray(q), jnp.asarray(meta), method,
                               reduce)
    ji, jv = jdsa.select_blocks(scores, jcfg, jnp.asarray(cur_len + 1))
    s_ref = _masked_scores(np.asarray(scores), tcfg, cur_len + 1)
    assert_same_selection(ti.numpy(), tv.numpy(), np.asarray(ji),
                          np.asarray(jv), s_ref, tcfg.top_k_blocks)
    seen = []
    real = ops.score_select

    def spy(*a, **kw):
        seen.append((kw["metadata"], kw["group_reduce"]))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "score_select", spy)
    ops.launches.reset()
    with pytest.raises(ValueError, match="score_select: tensors on meta"):
        tdsa.score_and_select(torch.from_numpy(q).bfloat16().to("meta"),
                              torch.from_numpy(meta).to("meta"), tcfg,
                              torch.from_numpy(cur_len).to("meta"), reduce)
    assert seen == [(method, reduce)]
    assert sum(ops.launches.counts.values()) == 0
    with pytest.raises(ValueError, match="no scoring"):
        tdsa.score_and_select(torch.from_numpy(q), torch.from_numpy(meta),
                              tcfg, torch.from_numpy(cur_len), "mean")


@pytest.mark.parametrize("moved", [None, 0, 1, 2])
def test_score_select_takes_plain_version_only_when_all_on_cpu(moved):
    """With q, meta and cur_len on the CPU the wrapper returns its plain
    version; with one of them elsewhere (the ``meta`` device, standing in
    for the card) it raises ValueError and counts no launch."""
    g = torch.Generator().manual_seed(0)
    args = [torch.randn((2, 4, 16), generator=g).to(torch.bfloat16),
            torch.randn((2, 2, 8, 2, 16), generator=g),
            torch.tensor([30, 17], dtype=torch.int32)]
    kw = dict(block_size=4, top_k=3, sink_blocks=1, recent_blocks=2)
    ops.launches.reset()
    if moved is None:
        idx, valid = ops.score_select(*args, **kw)
        assert idx.device.type == valid.device.type == "cpu"
        assert tuple(idx.shape) == (2, 2, 3)
    else:
        args[moved] = args[moved].to("meta")
        with pytest.raises(ValueError):
            ops.score_select(*args, **kw)
    assert sum(ops.launches.counts.values()) == 0


def test_gqa_select_step_selects_through_score_and_select(monkeypatch):
    """The model's select stage goes through ``score_and_select`` with the
    cache's tokens before the append (the +1 is the select's own)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as A
    seen = []
    real = tdsa.score_and_select

    def spy(q, meta, cfg, cur_len, *a):
        seen.append(cur_len.clone())
        return real(q, meta, cfg, cur_len, *a)
    monkeypatch.setattr(tdsa, "score_and_select", spy)
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dsa=TDSA(block_size=8, token_budget=32))
    B, Hkv, hd, NB = 2, cfg.num_kv_heads, cfg.head_dim, 4
    g = torch.Generator().manual_seed(0)
    d = cfg.d_model
    p = {"wq": torch.randn((d, cfg.num_heads * hd), generator=g),
         "wk": torch.randn((d, Hkv * hd), generator=g),
         "wv": torch.randn((d, Hkv * hd), generator=g)}
    cache = {"k": torch.zeros((B, Hkv, NB, 8, hd)),
             "v": torch.zeros((B, Hkv, NB, 8, hd)),
             "meta": torch.zeros((B, Hkv, NB, 2, hd))}
    cur_len = torch.tensor([8, 3], dtype=torch.int32)
    _, _, idx, valid = A.gqa_select_step(p, cfg, torch.randn(
        (B, d), generator=g), cache, cur_len)
    assert len(seen) == 1 and torch.equal(seen[0], cur_len)
    # 9 tokens after the append: blocks 0 and 1 valid (sink, recent)
    assert sorted(idx[0, 0][valid[0, 0]].tolist()) == [0, 1]
