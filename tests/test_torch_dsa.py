"""The port's DSA primitives (``repro_torch.core.dsa``) against the
reference's (``repro.core.dsa``) on the same numpy inputs made from a
seed.  Float tolerances: atol/rtol 1e-5 (float32 sums in another order).
Selections are compared as per-(request, kv-head) id SETS: ``torch.topk``
orders ties otherwise than ``jax.lax.top_k``, and sink / recent blocks are
all forced to +inf."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsa as jdsa
from repro.models.common import DSAConfig as JDSA
from repro_torch.core import dsa as tdsa
from repro_torch.models.common import DSAConfig as TDSA

ATOL = RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("method", ["cuboid", "mean"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_build_block_metadata(method, with_valid):
    r = np.random.default_rng(0)
    keys = r.standard_normal((2, 3, 5, 8, 16), dtype=np.float32)
    valid = None
    if with_valid:
        S = np.asarray([[19], [0]])       # ragged last block; an empty row
        valid = np.broadcast_to(
            (np.arange(40).reshape(5, 8)[None, :] < S[:, :, None])[
                :, None], (2, 3, 5, 8)).copy()
    got = tdsa.build_block_metadata(_t(keys), method,
                                    None if valid is None else _t(valid))
    want = jdsa.build_block_metadata(jnp.asarray(keys), method,
                                     None if valid is None
                                     else jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("method", ["cuboid", "mean"])
@pytest.mark.parametrize("reduce", ["max", "sum"])
def test_score_blocks(method, reduce):
    r = np.random.default_rng(1)
    q = r.standard_normal((2, 14, 32), dtype=np.float32)
    shape = (2, 2, 11, 2, 32) if method == "cuboid" else (2, 2, 11, 32)
    meta = r.standard_normal(shape, dtype=np.float32)
    if method == "cuboid":
        meta[..., 1, :] = meta[..., 0, :] + np.abs(meta[..., 1, :])
    got = tdsa.score_blocks(_t(q), _t(meta), method, reduce)
    want = jdsa.score_blocks(jnp.asarray(q), jnp.asarray(meta), method,
                             reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("bs,budget,NB", [(8, 32, 12), (32, 2048, 40),
                                          (8, 64, 5)])
def test_select_blocks_same_id_sets(bs, budget, NB):
    r = np.random.default_rng(NB)
    B, Hkv = 4, 2
    scores = r.standard_normal((B, Hkv, NB), dtype=np.float32)
    scores[0, 0, 3:6] = 0.5                 # explicit score ties
    cur_len = np.asarray([1, bs * NB, bs * 3 + 1, bs * (NB // 2)],
                         np.int32)
    tcfg, jcfg = TDSA(block_size=bs, token_budget=budget), \
        JDSA(block_size=bs, token_budget=budget)
    ti, tv = tdsa.select_blocks(_t(scores), tcfg, _t(cur_len))
    ji, jv = jdsa.select_blocks(jnp.asarray(scores), jcfg,
                                jnp.asarray(cur_len))
    ji, jv = np.asarray(ji), np.asarray(jv)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == ji.shape
    for b in range(B):
        for h in range(Hkv):
            got = set(ti[b, h][tv[b, h]].tolist())
            want = set(ji[b, h][jv[b, h]].tolist())
            assert got == want, (b, h)
        assert tdsa.selected_block_ids(ti[b].numpy()) == \
            jdsa.selected_block_ids(ji[b])


def _attn_case(seed, G=7):
    r = np.random.default_rng(seed)
    B, Hkv, NB, bs, D, K = 2, 2, 9, 8, 16, 4
    q = r.standard_normal((B, Hkv * G, D), dtype=np.float32)
    kp = r.standard_normal((B, Hkv, NB, bs, D), dtype=np.float32)
    vp = r.standard_normal((B, Hkv, NB, bs, D), dtype=np.float32)
    idx = np.argsort(r.random((B, Hkv, NB)), axis=-1)[..., :K].astype(
        np.int32)
    valid = r.random((B, Hkv, K)) > 0.3
    valid[:, :, 0] = True
    cur_len = np.asarray([NB * bs - 3, 37], np.int32)
    idx[:, :, 0] = 0
    return q, kp, vp, idx, valid, cur_len


def test_sparse_decode_attention_ref():
    q, kp, vp, idx, valid, cur_len = _attn_case(4)
    got = tdsa.sparse_decode_attention_ref(*map(_t, (q, kp, vp, idx, valid,
                                                     cur_len)))
    want = jdsa.sparse_decode_attention_ref(*map(jnp.asarray, (
        q, kp, vp, idx, valid, cur_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_full_decode_attention_ref():
    q, kp, vp, _, _, cur_len = _attn_case(5, G=4)
    got = tdsa.full_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(cur_len))
    want = jdsa.full_decode_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                          jnp.asarray(vp),
                                          jnp.asarray(cur_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
