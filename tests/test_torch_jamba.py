"""jamba-v0.1-52b (the hybrid: Mamba layers with one attention layer in
every ``attn_layer_period``, MoE on every second layer) in the port
against the reference, on the CPU.

Two configs, in float32 with the reference's weights handed over through
``bridge.py``, DSA at block 8 and budget 32 (top-4 blocks, so the
selection drops blocks): the smoke (2 layers: a Mamba layer with a dense
FFN, then attention with the MoE), and ``interleave``, the smoke's widths
over 8 layers with the full config's interleave (period 8, offset 4: one
attention layer, model layer 4; MoE on the odd layers, so Mamba layers
carry MoEs).

- the configs and the layer kinds are the reference's;
- prefill and decode logits of the whole model, atol 5e-4, the selected
  block sets exactly, under teacher forcing: float32 sums in another
  order, and the smoke's MoE after its attention layer (the reference's
  experts at std 1 / sqrt(E) = 0.5) writes O(1000) into the residual
  stream, where one float32 step is ~1e-4, before the final norm brings
  the logits back to O(1) (the largest difference seen is 1.2e-4);
- the engine's greedy tokens, ``TransferStats``, modelled clock and
  prefill watermark against the JAX ``ServingEngine`` on the same
  submissions on the default mixed walk, fp and int8 (the other paths
  are in ``test_torch_jamba_paths.py``);
- the HBM cache's keys: between each attention layer's restore and its
  attend, every request's LRU keys equal the reference's, in order: KV
  layers are attention ordinals (model layer 4 is KV layer 0);
- the reference's bars inside the port: mixed == split == sequential
  under a 1-block LRU (``tests/test_hybrid_plane.py``), the recurrent
  state carried exactly over chunked layer segments and the prefill
  watermark counting attention layers only
  (``tests/test_prefill_plane.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_cfg
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_cfg
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.layer_prefill import plan_segments
from repro_torch.core.prefill_plane import PrefillPlane
from repro_torch.models import model as TM
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request
from test_torch_jamba_paths import one_thread  # noqa: F401

ARCH = "jamba-v0.1-52b"
LOGIT_ATOL = 5e-4
PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
INTERLEAVE = dict(num_layers=8, attn_layer_period=8, attn_layer_offset=4,
                  moe_layer_period=2)
_jax_decode_step = jax.jit(
    lambda p, c, t, s: JM.decode_step(p, c, t, s, return_info=True),
    static_argnums=1)


def _variant(cfg, variant):
    cfg = dataclasses.replace(cfg, dsa=type(cfg.dsa)(block_size=8,
                                                     token_budget=32))
    return (dataclasses.replace(cfg, **INTERLEAVE)
            if variant == "interleave" else cfg)


@pytest.fixture(scope="module")
def pair():
    cache = {}

    def get(variant):
        if variant not in cache:
            jc = _variant(jax_smoke(ARCH), variant)
            tc = _variant(torch_smoke(ARCH), variant)
            jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                                   jc.num_layers, device="cpu")
            cache[variant] = (jc, tc, jp, tp)
        return cache[variant]
    return get


def test_config_is_the_reference_config(pair):
    assert dataclasses.asdict(torch_cfg(ARCH)) == \
        dataclasses.asdict(jax_cfg(ARCH))
    assert dataclasses.asdict(torch_smoke(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))
    full = torch_cfg(ARCH)
    TM.check_supported(full)
    kinds = [TM.layer_kind(full, i) for i in range(full.num_layers)]
    assert kinds == [JM.layer_kind(jax_cfg(ARCH), i)
                     for i in range(full.num_layers)]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [4, 12, 20, 28]
    for variant in ("smoke", "interleave"):
        jc, tc, _, tp = pair(variant)
        kinds = [TM.layer_kind(tc, i) for i in range(tc.num_layers)]
        assert kinds == [JM.layer_kind(jc, i) for i in range(jc.num_layers)]
        for i, p in enumerate(tp["layers"]):
            assert ("mamba" in p) == (kinds[i] == "mamba")
            assert ("moe" in p) == tc.is_moe_layer(i)
    # the interleave puts MoEs after Mamba mixers; the smoke does not
    _, tc, _, _ = pair("interleave")
    assert any(TM.layer_kind(tc, i) == "mamba" and tc.is_moe_layer(i)
               for i in range(tc.num_layers))


@pytest.mark.parametrize("variant", ["smoke", "interleave"])
def test_prefill_and_decode_logits_match(variant, pair):
    jc, tc, jp, tp = pair(variant)
    r = np.random.default_rng(3)
    toks = r.integers(4, jc.vocab_size, (2, 45)).astype(np.int32)
    nb = -(-(45 + 4) // 8) + 1
    jl, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, nb)
    tl, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, nb,
                         cache_dtype=torch.bfloat16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jst, jinfo = _jax_decode_step(jp, jc, jnp.asarray(nxt), jst)
        tl, tst, tinfo = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst,
                                        return_info=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        assert set(tinfo["selected"]) == set(jinfo["selected"]) == {
            i for i in range(tc.num_layers)
            if TM.layer_kind(tc, i) == "attn"}
        for l, idx in tinfo["selected"].items():
            assert (np.sort(idx.numpy(), -1)
                    == np.sort(np.asarray(jinfo["selected"][l]), -1)).all()


def _run(engine_cls, config_cls, request_cls, cfg, params, probe=None,
         prompts=PROMPTS, arrivals=ARRIVALS, gen=GEN, **kw):
    eng = engine_cls(params, cfg, config_cls(r_max=4, chunk_size=64, **kw))
    eng.staged_probe = probe
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


def _lru_probe(log):
    """A staged probe recording, per call, the layer and every request's
    LRU keys in order."""
    def probe(engine, plane, layer, sts, blocks_by_req):
        log.append((layer, [list(engine.kv_mgr.caches[st.req.req_id]._lru)
                            for st in sts]))
    return probe


@pytest.fixture(scope="module")
def runs(pair):
    """Each (variant, tier)'s JAX and port runs, shared by the tests
    below; the fp ones with the LRU probe."""
    cache = {}

    def get(variant, tier):
        if (variant, tier) not in cache:
            jc, tc, jp, tp = pair(variant)
            out = []
            for args in ((JEngine, JEngineConfig, JRequest, jc, jp),
                         (ServingEngine, EngineConfig, Request, tc, tp)):
                log = []
                out.append(_run(*args, probe=_lru_probe(log),
                                offload_quant=tier) + (log,))
            cache[variant, tier] = out
        return cache[variant, tier]
    return get


@pytest.mark.parametrize("tier", ["none", "int8"])
@pytest.mark.parametrize("variant", ["smoke", "interleave"])
def test_engine_matches_reference(variant, tier, runs):
    (j_eng, j_tokens, j_stats, j_m, _), (eng, t_tokens, t_stats, t_m, _) = \
        runs(variant, tier)
    assert t_tokens == j_tokens
    assert all(len(t) == GEN for t in t_tokens)
    assert t_stats == j_stats
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.prefill_hbm_peak_tokens == j_eng.prefill_hbm_peak_tokens > 0
    assert eng.hybrid is not None
    # the host stage of a decode-only iteration ran at the attention
    # layers only
    attn = {i for i in range(eng.cfg.num_layers)
            if TM.layer_kind(eng.cfg, i) == "attn"}
    for e in eng.mixed_iter_log:
        assert all(lay["attn"] == (i in attn)
                   for i, lay in e["layers"].items())
        if e["decode_rows"] and not e["prefill_rows"]:
            assert set(e["layers"]) == attn


@pytest.mark.parametrize("variant", ["smoke", "interleave"])
def test_hbm_cache_keys_are_attention_ordinals(variant, runs):
    """Between each attention layer's restore and its attend, every
    request's LRU holds the reference's keys in the reference's order;
    the KV layer of a key is the attention ordinal, so the interleave's
    model layer 4 keeps its blocks under KV layer 0."""
    (_, _, _, _, j_log), (eng, _, _, _, t_log) = runs(variant, "none")
    assert t_log == j_log and t_log
    n_attn = eng.geom.num_layers
    assert n_attn == eng.cfg.num_attention_layers() == 1
    for layer, lrus in t_log:
        assert TM.layer_kind(eng.cfg, layer) == "attn"
        assert all(key[0] < n_attn for lru in lrus for key in lru)
    assert eng._layer_to_lidx[4 if variant == "interleave" else 1] == 0
    assert eng._lidx_to_layer == {0: 4 if variant == "interleave" else 1}


@pytest.mark.parametrize("variant", ["smoke", "interleave"])
def test_mixed_equals_split_equals_sequential_under_one_block_lru(
        variant, pair):
    """The reference's bar (tests/test_hybrid_plane.py, its hybrid case)
    inside the port: prefill rides decode iterations under a 1-block
    LRU, and mixed, split and the sequential decode give the same
    tokens."""
    _, tc, _, tp = pair(variant)
    kw = dict(prompts=(48, 96, 72, 40), arrivals=(0.0, 0.0, 0.005, 0.02),
              hbm_blocks_per_request=1, gen=3)
    e_m, toks_m, s_m, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                               **kw)
    _, toks_s, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                           hybrid_plane="split", **kw)
    _, toks_q, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                           batched_decode=False, **kw)
    assert toks_m == toks_s == toks_q
    assert all(len(t) == 3 for t in toks_m)
    assert s_m["evictions"] > 0 and s_m["misses"] > 0
    assert any(e["decode_rows"] > 0 and e["prefill_rows"] > 0
               for e in e_m.mixed_iter_log)


def test_chunked_rec_state_carries_exactly(pair):
    """The reference's bar (tests/test_prefill_plane.py): the Mamba state
    and its conv window carried across same-layer chunks give the tokens
    of whole-layer segments over a longer generation."""
    _, tc, _, tp = pair("interleave")
    _, toks_whole, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                               prompts=(72,), arrivals=(0.0,), gen=6)
    e_c, toks_chunk, _, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                 tp, prompts=(72,), arrivals=(0.0,), gen=6,
                                 prefill_max_tokens_per_step=16)
    assert toks_whole == toks_chunk
    # 5 chunks of 16 tokens per layer over the 72-token prompt
    assert e_c.prefill_launches == 5 * tc.num_layers


def test_watermark_counts_only_attention_layers(pair):
    """The reference's bar (tests/test_prefill_plane.py): a hybrid row's
    watermark peak is its chunk progress through attention layers and
    exactly 0 while a Mamba layer's segments run."""
    _, tc, _, tp = pair("interleave")
    h, _, _ = TM.prefill_embed(
        tp, tc, {"tokens": torch.arange(5, 53, dtype=torch.int32)[None]})
    plane = PrefillPlane(tc)
    segs = plan_segments(48, tc.num_layers, 16)        # 3 chunks per layer
    plane.admit("r0", h, segs)
    kinds_seen = set()
    while not plane.done("r0"):
        seg = segs[plane.next_idx["r0"]]
        kind = TM.layer_kind(tc, seg.layer)
        kinds_seen.add(kind)
        res = plane.run_iteration(tp, {"r0": 1})       # one segment
        assert [g.kind for g in res.groups] == [kind]
        assert res.peaks["r0"] == (seg.chunk_start + seg.chunk_len
                                   if kind == "attn" else 0), (seg, kind)
    assert kinds_seen == {"attn", "mamba"}
    di = tc.mamba_expand * tc.d_model
    rec = sum(4 * (tc.mamba_d_conv - 1) * di + 4 * di * tc.mamba_d_state
              for i in range(tc.num_layers)
              if TM.layer_kind(tc, i) == "mamba") * plane.b_cap
    assert plane.device_bytes() == (
        plane.hidden.numel() * 4 + plane.ctx_k.numel() * 8
        + plane.b_cap * 4 + rec)
