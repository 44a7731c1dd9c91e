"""MLA (minicpm3-4b's multi-head latent attention) in the port against the
reference, on the CPU.

Two variants of the config, both float32 with the reference's weights
handed over through ``bridge.py``: ``smoke`` (the config's own
``smoke_config()``) and ``wide`` (the smoke's two narrow layers with the
full config's attention: 40 heads, q_lora 768, kv_lora 256, nope 64, rope
32, v 64, so the decode attends with G = 40 over a 288-wide latent head
and the prefill runs D 96 against Dv 64).  A reduced DSA config (block 8,
budget 32 -> top-4 blocks) makes the selection drop blocks.

- the attention functions (``mla_self_attention`` with its latent,
  ``_mla_project_decode``, ``mla_select_step`` plain and masked,
  ``mla_attend_step``) on the same numpy inputs: atol 1e-4 (float32
  sums in another order), the selections tie-aware (sel_valid counts, the
  reference's scores of the selected blocks as sorted lists, the id sets
  wherever the K-th and (K+1)-th scores differ by more than 1e-5);
- prefill and decode logits of the whole model, atol 1e-4, the selected
  block sets exactly;
- the engine's greedy tokens, ``TransferStats`` and modelled clock against
  the JAX ``ServingEngine`` on the same submissions (default path, a
  prompt of several blocks, the default LRU and a 1-block LRU that
  evicts), the int8 tier too; the chunked baseline raising on both sides;
- the reference's equalities inside the port on MLA: mixed == split under
  a 1-block LRU, plane == legacy prefill, async == sync, staged ==
  persistent == stacked;
- the host pools: one latent head stored, while every counter matches the
  reference's pools, which broadcast it over the 40 (here 4) heads."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_cfg
from repro.configs import get_smoke_config as jax_smoke
from repro.core import dsa as jdsa
from repro.models import attention as JA
from repro.models import model as JM
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_cfg
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

ARCH = "minicpm3-4b"
ATOL = 1e-4
SEL_TOL = 1e-5
MLA_KEYS = {"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk",
            "w_uv", "wo"}
PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
_jax_decode_step = jax.jit(
    lambda p, c, t, s: JM.decode_step(p, c, t, s, return_info=True),
    static_argnums=1)


def _variant(cfg, full, variant):
    cfg = dataclasses.replace(cfg, dsa=type(cfg.dsa)(block_size=8,
                                                     token_budget=32))
    if variant == "wide":
        cfg = dataclasses.replace(cfg, num_heads=full.num_heads,
                                  num_kv_heads=full.num_kv_heads,
                                  mla=full.mla)
    return cfg


@pytest.fixture(scope="module")
def pair():
    cache = {}

    def get(variant):
        if variant not in cache:
            jc = _variant(jax_smoke(ARCH), jax_cfg(ARCH), variant)
            tc = _variant(torch_smoke(ARCH), torch_cfg(ARCH), variant)
            jp = jax.tree.map(np.asarray, JM.init_params(
                jc, jax.random.PRNGKey(0), jnp.float32))
            tp = params_from_numpy(jp, jc.num_layers, device="cpu")
            cache[variant] = (jc, tc, jax.tree.map(jnp.asarray, jp), tp)
        return cache[variant]
    return get


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            tp["layers"][0]["attn"])


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


def test_configs_and_bridge_keys(pair):
    assert dataclasses.asdict(torch_cfg(ARCH)) == \
        dataclasses.asdict(jax_cfg(ARCH))
    full = torch_cfg(ARCH)
    assert (full.num_layers, full.num_heads, full.mla.latent_dim,
            full.mla.qk_nope_head_dim + full.mla.qk_rope_head_dim,
            full.mla.v_head_dim) == (62, 40, 288, 96, 64)
    jc, tc, jp, tp = pair("wide")
    assert set(tp["layers"][0]["attn"]) == MLA_KEYS
    for name in MLA_KEYS:
        np.testing.assert_array_equal(
            tp["layers"][1]["attn"][name].numpy(),
            np.asarray(jp["layers"]["attn"][name][1]))


@pytest.mark.parametrize("variant", ["smoke", "wide"])
def test_mla_self_attention_matches(variant, pair):
    jc, tc, jp, tp = pair(variant)
    jl, tl = _layer0(jp, tp)
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 37, jc.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37))
    jo, jlat = JA.mla_self_attention(jl, jc, jnp.asarray(x),
                                     jnp.asarray(pos), return_latent=True)
    to, tlat = TA.mla_self_attention(tl, tc, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()),
                                     return_latent=True)
    assert tlat.shape == (2, 37, tc.mla.latent_dim)
    _close(to, jo)
    _close(tlat, jlat)


@pytest.mark.parametrize("variant", ["smoke", "wide"])
def test_mla_project_decode_matches(variant, pair):
    jc, tc, jp, tp = pair(variant)
    jl, tl = _layer0(jp, tp)
    r = np.random.default_rng(3)
    x = r.standard_normal((3, jc.d_model), dtype=np.float32)
    cur = np.asarray([0, 5, 37], np.int32)
    jq, jlat = JA._mla_project_decode(jl, jc, jnp.asarray(x),
                                      jnp.asarray(cur))
    tq, tlat = TA._mla_project_decode(tl, tc, torch.from_numpy(x),
                                      torch.from_numpy(cur))
    assert tq.shape == (3, tc.num_heads, tc.mla.latent_dim)
    _close(tq, jq)
    _close(tlat, jlat)


def _prefilled(jc, tc, jp, tp, S=45, nb=8):
    toks = np.random.default_rng(4).integers(
        4, jc.vocab_size, (2, S)).astype(np.int32)
    _, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, nb,
                        cache_dtype=jnp.float32)
    _, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, nb,
                        cache_dtype=torch.float32)
    jcache = jax.tree.map(lambda a: a[0], jst["caches"]) \
        if isinstance(jst["caches"], dict) else jst["caches"][0]
    return jcache, tst["caches"][0], np.asarray([S, S - 13], np.int32)


def _same_selection(t_idx, t_valid, j_idx, j_valid, scores, K):
    """Tie-aware: per (request, kv-head) equal sel_valid counts, equal
    reference scores of the selected blocks as sorted lists, and equal id
    sets where the K-th and (K+1)-th scores are apart."""
    B, H, NB = scores.shape
    for b in range(B):
        for h in range(H):
            tv, jv = t_valid[b, h], j_valid[b, h]
            assert tv.sum() == jv.sum()
            ti, ji = t_idx[b, h][tv], j_idx[b, h][jv]
            assert len(set(ti.tolist())) == len(ti)
            np.testing.assert_allclose(np.sort(scores[b, h, ti]),
                                       np.sort(scores[b, h, ji]),
                                       atol=SEL_TOL, rtol=SEL_TOL)
            order = np.sort(scores[b, h])[::-1]
            if K < NB and not np.isclose(order[K - 1], order[K],
                                         atol=SEL_TOL, rtol=SEL_TOL):
                assert set(ti.tolist()) == set(ji.tolist())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", ["smoke", "wide"])
def test_mla_select_step_matches(variant, masked, pair):
    jc, tc, jp, tp = pair(variant)
    jl, tl = _layer0(jp, tp)
    jcache, tcache, cur = _prefilled(jc, tc, jp, tp)
    x = np.random.default_rng(5).standard_normal((2, jc.d_model),
                                                 dtype=np.float32)
    mask = np.asarray([True, False]) if masked else None
    jq, jnew, jidx, jvalid = JA.mla_select_step(
        jl, jc, jnp.asarray(x), jcache, jnp.asarray(cur),
        step_mask=None if mask is None else jnp.asarray(mask))
    tq, tnew, tidx, tvalid = TA.mla_select_step(
        tl, tc, torch.from_numpy(x), tcache, torch.from_numpy(cur),
        step_mask=None if mask is None else torch.from_numpy(mask))
    assert set(tnew) == {"k", "meta"}
    assert tnew["k"].shape[1] == 1            # one latent head
    _close(tq, jq)
    _close(tnew["k"], jnew["k"])
    _close(tnew["meta"], jnew["meta"])
    scores = np.asarray(jdsa.score_blocks(jq, jnew["meta"],
                                          jc.dsa.metadata))
    n_valid = -(-(cur + 1) // jc.dsa.block_size)
    blk = np.arange(scores.shape[-1])
    live = blk[None] < n_valid[:, None]
    forced = live & ((blk[None] < jc.dsa.sink_blocks)
                     | (blk[None] >= (n_valid - jc.dsa.recent_blocks)[:,
                                                                     None]))
    s = np.where(forced[:, None], np.inf,
                 np.where(live[:, None], scores, -1e30))
    _same_selection(tidx.numpy(), tvalid.numpy(), np.asarray(jidx),
                    np.asarray(jvalid), s, jc.dsa.top_k_blocks)


@pytest.mark.parametrize("variant", ["smoke", "wide"])
def test_mla_attend_step_matches(variant, pair):
    """The attend stage on the same cache and selection: the reference's
    ids (as numpy) go to both sides."""
    jc, tc, jp, tp = pair(variant)
    jl, tl = _layer0(jp, tp)
    jcache, tcache, cur = _prefilled(jc, tc, jp, tp)
    x = np.random.default_rng(6).standard_normal((2, jc.d_model),
                                                 dtype=np.float32)
    jq, jnew, jidx, jvalid = JA.mla_select_step(
        jl, jc, jnp.asarray(x), jcache, jnp.asarray(cur))
    tq, tnew, _, _ = TA.mla_select_step(tl, tc, torch.from_numpy(x),
                                        tcache, torch.from_numpy(cur))
    jo = JA.mla_attend_step(jl, jc, jq, jnew, jnp.asarray(cur), jidx, jvalid)
    to = TA.mla_attend_step(
        tl, tc, tq, tnew, torch.from_numpy(cur),
        torch.from_numpy(np.asarray(jidx).astype(np.int32)),
        torch.from_numpy(np.array(jvalid)))
    assert to.shape == (2, tc.d_model)
    _close(to, jo)


@pytest.mark.parametrize("variant", ["smoke", "wide"])
def test_prefill_and_decode_logits_match(variant, pair):
    jc, tc, jp, tp = pair(variant)
    r = np.random.default_rng(1)
    S, steps, nb = 37, 5, 8
    toks = r.integers(4, jc.vocab_size, (2, S)).astype(np.int32)
    jl, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, nb,
                         cache_dtype=jnp.float32)
    tl, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, nb,
                         cache_dtype=torch.float32)
    assert set(tst["caches"][0]) == {"k", "meta"}
    _close(tl, jl)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst, jinfo = _jax_decode_step(jp, jc, jnp.asarray(nxt), jst)
        tl, tst, tinfo = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst,
                                        return_info=True)
        _close(tl, jl)
        for layer in range(jc.num_layers):
            jsel = np.asarray(jinfo["selected"][layer])
            tsel = tinfo["selected"][layer].numpy()
            for b in range(2):
                assert set(tsel[b, 0].ravel()) == set(jsel[b, 0].ravel())
    assert int(tst["cur_len"][0]) == S + steps


def _run(engine_cls, config_cls, request_cls, cfg, params, prompts=PROMPTS,
         arrivals=ARRIVALS, gen=GEN, **kw):
    eng = engine_cls(params, cfg, config_cls(r_max=4, chunk_size=64, **kw))
    rng = np.random.default_rng(7)
    ids = []
    for p, t in zip(prompts, arrivals):
        r = request_cls(prompt_len=p, max_new_tokens=gen, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32))
        ids.append(r.req_id)
    metrics = eng.run()
    return (eng, [eng.states[i].out_tokens for i in ids],
            dataclasses.asdict(eng.transfer_stats()), metrics)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("hbm_blocks", [96, 1])
def test_engine_matches_reference(hbm_blocks, quant, pair):
    jc, tc, jp, tp = pair("smoke")
    kw = dict(hbm_blocks_per_request=hbm_blocks, offload_quant=quant)
    _, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest, jc,
                                     jp, **kw)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp, **kw)
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    assert t_stats["h2d_calls"] > 0 and t_stats["d2h_calls"] > 0
    if hbm_blocks == 1:
        assert t_stats["evictions"] > 0
        assert eng.plane.blocks_dropped > 0
        assert eng.plane.blocks_restored_before_use > 0
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.plane.host_syncs == eng.plane.steps * tc.num_layers
    assert sum(ops.launches.snapshot().values()) == 0


def test_host_pool_holds_one_latent_head(pair):
    """The pinned pool stores the latent once; the reference's numpy pool
    broadcasts it over num_kv_heads.  Geometry, wire bytes and every
    counter are the reference's, and the one stored head equals each of
    the reference's copies."""
    jc, tc, jp, tp = pair("smoke")
    kw = dict(hbm_blocks_per_request=1)
    j_eng = JEngine(jp, jc, JEngineConfig(r_max=4, chunk_size=64, **kw))
    t_eng = ServingEngine(tp, tc, EngineConfig(r_max=4, chunk_size=64, **kw))
    assert dataclasses.asdict(t_eng.geom) == dataclasses.asdict(j_eng.geom)
    assert (t_eng.geom.num_kv_heads, t_eng.geom.kv_factor,
            t_eng.geom.stored_heads) == (4, 1, 1)
    assert t_eng._offload_block_bytes == j_eng._offload_block_bytes
    toks = np.random.default_rng(8).integers(4, jc.vocab_size, 40).astype(
        np.int32)
    for eng, req in ((j_eng, JRequest), (t_eng, Request)):
        eng.submit(req(prompt_len=40, max_new_tokens=3, arrival_time=0.0,
                       req_id="r"), tokens=toks)
    jpool, tpool = j_eng.kv_mgr.pools["r"], t_eng.kv_mgr.pools["r"]
    assert tpool.v is None and jpool.v is None
    assert tuple(tpool.k.shape) == (tc.num_layers, 1) + jpool.k.shape[2:]
    assert jpool.k.shape[1] == tc.num_kv_heads
    assert tpool.wire_bytes(3) == jpool.wire_bytes(3)
    for _ in range(3):          # the prefill and two decode steps
        j_eng.step()
        t_eng.step()
    t_eng.close()
    assert dataclasses.asdict(t_eng.transfer_stats()) == \
        dataclasses.asdict(j_eng.transfer_stats())
    np.testing.assert_allclose(
        np.broadcast_to(tpool.k.numpy(), jpool.k.shape), jpool.k,
        atol=ATOL)


def test_chunked_prefill_raises_on_both_sides(pair):
    jc, tc, jp, tp = pair("smoke")
    with pytest.raises(NotImplementedError):
        JEngine(jp, jc, JEngineConfig(prefill_mode="chunked"))
    with pytest.raises(NotImplementedError):
        ServingEngine(tp, tc, EngineConfig(prefill_mode="chunked"))


def test_whole_layer_segments_and_chunked_segment_raises(pair):
    """A segment cap leaves MLA's prefill whole-layer (the reference's
    engine does the same), and the plane refuses a chunk with context."""
    from repro_torch.core.layer_prefill import plan_segments
    from repro_torch.core.prefill_plane import PrefillPlane
    jc, tc, jp, tp = pair("smoke")
    kw = dict(prompts=(72,), arrivals=(0.0,), gen=2,
              prefill_max_tokens_per_step=32)
    j_eng, j_toks, j_stats, _ = _run(JEngine, JEngineConfig, JRequest, jc,
                                     jp, **kw)
    t_eng, t_toks, t_stats, _ = _run(ServingEngine, EngineConfig, Request,
                                     tc, tp, **kw)
    assert t_toks == j_toks and t_stats == j_stats
    assert t_eng.prefill_launches == tc.num_layers
    plane = PrefillPlane(tc)
    h = tp["embed"][torch.zeros((1, 72), dtype=torch.long)]
    plane.admit("r", h, plan_segments(72, tc.num_layers, 32))
    with pytest.raises(NotImplementedError):
        plane.run_iteration(tp, {"r": 72})


def test_mixed_equals_split_under_one_block_lru(pair):
    _, tc, _, tp = pair("smoke")
    kw = dict(prompts=(48, 96, 72, 40), arrivals=(0.0, 0.0, 0.005, 0.02),
              hbm_blocks_per_request=1)
    e_m, toks_m, stats_m, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, **kw)
    e_s, toks_s, stats_s, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, hybrid_plane="split", **kw)
    assert toks_m == toks_s
    assert all(len(t) == GEN for t in toks_m)
    assert e_m.hybrid is not None and e_s.hybrid is None
    assert any(e["decode_rows"] > 0 and e["prefill_rows"] > 0
               for e in e_m.mixed_iter_log)
    assert e_s.plane.blocks_restored_before_use > 0


def test_plane_equals_legacy(pair):
    _, tc, _, tp = pair("smoke")
    kw = dict(prompts=(48, 96, 72, 64), arrivals=(0.0,) * 4)
    e_p, toks_p, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                             **kw)
    e_l, toks_l, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                             prefill_exec="legacy", **kw)
    assert toks_p == toks_l
    assert e_p.prefill_launches > 0 and e_l.prefill_launches == 0


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_async_equals_sync(quant, pair):
    _, tc, _, tp = pair("smoke")
    kw = dict(hbm_blocks_per_request=1, offload_quant=quant)
    e_a, toks_a, stats_a, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, **kw)
    e_s, toks_s, stats_s, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, stage_dispatch="sync", **kw)
    assert toks_a == toks_s
    assert stats_a == stats_s
    assert e_a.worker_jobs_run > 0 and e_s.worker_jobs_run == 0


def test_staged_equals_persistent_equals_stacked(pair):
    """The reference's engine serves MLA on every decode plane; the port's
    three give the same tokens and restore traffic under a 1-block LRU."""
    _, tc, _, tp = pair("smoke")
    kw = dict(prompts=(48, 96, 72), arrivals=(0.0, 0.0, 0.0), gen=5,
              hbm_blocks_per_request=1)
    runs = {name: _run(ServingEngine, EngineConfig, Request, tc, tp, **kw,
                       **extra)
            for name, extra in (
                ("staged", dict(hybrid_plane="split")),
                ("persistent", dict(decode_plane="persistent")),
                ("stacked", dict(decode_plane="stacked")))}
    toks = {name: r[1] for name, r in runs.items()}
    assert toks["staged"] == toks["persistent"] == toks["stacked"]
    s = {n: runs[n][2] for n in runs}
    assert (s["staged"]["h2d_blocks"] == s["persistent"]["h2d_blocks"]
            == s["stacked"]["h2d_blocks"] > 0)
    assert runs["staged"][0].plane.blocks_dropped > 0
    assert runs["stacked"][0].stack_calls > 0
