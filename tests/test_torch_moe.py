"""The MoE FFN of the port (kimi-k2-1t-a32b, arctic-480b) against the
reference, on the CPU.

- ``ffn.moe_apply`` against ``repro.models.ffn.moe_apply`` on the same
  numpy inputs and the reference's float32 weights (through
  ``bridge.py``), drop-free and with the capacity that drops pairs (a
  router biased to expert 0 over inputs with a common offset, so that
  most tokens pick it first): the expert ids of every (token, slot)
  pair, each pair's rank within its expert and the kept pairs equal; aux
  within atol 1e-5; out within 1e-5 of its scale (max |ref|): the
  reference's expert weights at std 1 / sqrt(E) give outputs of O(1000)
  at the smoke's widths, where one float32 step is ~6e-5.  At the
  smokes' expert counts and at the full configs' (E 384 top-8; E 128
  top-2 with the dense residual) over the smoke's d_model and d_ff.
- the parameter layout: the port's ``init_params`` against the
  reference's (``moe`` where ``is_moe_layer`` holds, ``ffn`` elsewhere;
  the router float32 in a bfloat16 model), and ``bridge`` keeping the
  router float32 when asked for bfloat16.
- the engine: greedy tokens, ``TransferStats`` and the modelled clock
  against the JAX ``ServingEngine`` on both smokes on the int8 tier (the
  fp tier is parametrised in ``test_torch_engine.py``), and on kimi-k2's
  smoke the legacy and chunked prefills against the reference's; inside
  the port, the reference's bars on kimi-k2's smoke: mixed == split
  under a 1-block LRU (``tests/test_hybrid_plane.py``), plane == legacy
  == chunked, staged == persistent == stacked, async == sync (int8).
  The per-expert count read-back is one per MoE call and is not a plane
  host sync."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_cfg
from repro.configs import get_smoke_config as jax_smoke
from repro.models import ffn as JF
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_cfg
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

ARCHS = ["kimi-k2-1t-a32b", "arctic-480b"]
ATOL = 1e-5
PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4


def _moe_cfgs(arch, variant):
    jc, tc = jax_smoke(arch), torch_smoke(arch)
    if variant == "experts":
        full = jax_cfg(arch)
        kw = dict(num_experts=full.num_experts,
                  top_k_experts=full.top_k_experts)
        jc, tc = (dataclasses.replace(jc, **kw),
                  dataclasses.replace(tc, **kw))
    return jc, tc


def _moe_inputs(jc, mode):
    """(reference params as numpy, x (2, 16, d) float32); ``biased``: the
    router's expert 0 column raised by 0.05 and every input offset by 2,
    so that expert 0 is most tokens' first choice."""
    jp = jax.tree.map(np.asarray, JF.init_moe_params(
        jc, jax.random.PRNGKey(3), jnp.float32))
    x = np.random.default_rng(4).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    if mode == "biased":
        jp["router"] = jp["router"].copy()
        jp["router"][:, 0] += 0.05
        x += 2.0
    return jp, x


@pytest.mark.parametrize("mode", ["drop_free", "capacity", "biased"])
@pytest.mark.parametrize("variant", ["smoke", "experts"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, variant, mode):
    jc, tc = _moe_cfgs(arch, variant)
    jp, x = _moe_inputs(jc, mode)
    tp = params_from_numpy({"layers": [jp]}, 1)["layers"][0]
    assert ("dense" in tp) == tc.moe_dense_residual
    drop_free = mode == "drop_free"
    T, k, E = x.shape[0] * x.shape[1], tc.top_k_experts, tc.num_experts

    j_out, j_aux = JF.moe_apply(jax.tree.map(jnp.asarray, jp), jc,
                                jnp.asarray(x), drop_free=drop_free)
    TF.moe_stats.reset()
    t_out, t_aux = TF.moe_apply(tp, tc, torch.from_numpy(x),
                                drop_free=drop_free)
    j_out = np.asarray(j_out)
    np.testing.assert_allclose(t_out.numpy(), j_out,
                               atol=ATOL * np.abs(j_out).max())
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=ATOL)

    # the routing: expert ids, each pair's rank in its expert, kept pairs
    xf = x.reshape(T, -1)
    j_probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    j_experts = np.asarray(jax.lax.top_k(j_probs, k)[1])
    _, t_experts, _ = TF.moe_route(tp, tc, torch.from_numpy(xf))
    np.testing.assert_array_equal(t_experts.numpy(), j_experts)
    cap = TF.moe_capacity(tc, T, drop_free)
    j_ranks = np.asarray(JF._dispatch_ranks_onehot(
        jnp.asarray(j_experts.reshape(-1), jnp.int32), E))
    order, counts, kept = TF.moe_dispatch(t_experts, E, cap)
    t_ranks = np.empty(T * k, np.int64)
    t_kept = np.zeros(T * k, bool)
    start = 0
    for c, n in zip(counts, kept):
        pairs = order[start:start + c].numpy()
        t_ranks[pairs] = np.arange(c)
        t_kept[pairs[:n]] = True
        start += c
    np.testing.assert_array_equal(t_ranks, j_ranks)
    np.testing.assert_array_equal(t_kept, j_ranks < cap)
    dropped = int((j_ranks >= cap).sum())
    if mode == "drop_free":
        assert dropped == 0
    if mode == "biased":       # expert 0 over its capacity
        assert counts[0] > cap and dropped >= counts[0] - cap
    assert TF.moe_stats.snapshot() == dict(
        readbacks=1, pairs=T * k, dropped=dropped, decode_calls=0,
        decode_touched=0, decode_touched_max=0)


def test_decode_shaped_call_counts_its_experts():
    jc, tc = _moe_cfgs("kimi-k2-1t-a32b", "experts")
    jp, _ = _moe_inputs(jc, "drop_free")
    tp = params_from_numpy({"layers": [jp]}, 1)["layers"][0]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 1, tc.d_model)).astype(np.float32))
    TF.moe_stats.reset()
    out, _ = TF.moe_apply(tp, tc, x, drop_free=True)
    s = TF.moe_stats.snapshot()
    assert out.shape == x.shape
    assert s["readbacks"] == s["decode_calls"] == 1 and s["dropped"] == 0
    assert s["decode_touched"] == s["decode_touched_max"] == len(
        set(TF.moe_route(tp, tc, x[:, 0])[1].flatten().tolist()))
    assert 8 <= s["decode_touched"] <= 4 * 8


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_is_the_reference_layout(arch):
    """The port's init_params gives the reference's keys and shapes (list
    mode, with moe_layer_period 2 so that dense and MoE layers
    alternate), the router float32 in a bfloat16 model."""
    jc = dataclasses.replace(jax_smoke(arch), moe_layer_period=2)
    tc = dataclasses.replace(torch_smoke(arch), moe_layer_period=2)
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(0), jnp.float32, stacked=False))
    tp = TM.init_params(tc, torch.Generator().manual_seed(0),
                        torch.bfloat16, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(tp) == shapes(jp)
    assert ["moe" in lp for lp in tp["layers"]] == [False, True]
    moe = tp["layers"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    # each expert drawn on its own at std 1 / sqrt(E)
    assert not torch.equal(moe["w_gate"][0], moe["w_gate"][1])
    assert float(moe["w_up"].float().std()) == pytest.approx(
        tc.num_experts ** -0.5, rel=0.05)


def test_bridge_keeps_the_router_float32():
    jc = jax_smoke("arctic-480b")
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(0), jnp.float32))
    tp = params_from_numpy(jp, jc.num_layers, dtype=torch.bfloat16)
    for lp in tp["layers"]:
        assert lp["moe"]["router"].dtype == torch.float32
        assert lp["moe"]["w_down"].dtype == torch.bfloat16
        assert lp["moe"]["dense"]["w_gate"].dtype == torch.bfloat16
        assert lp["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"][1]["moe"]["router"].numpy(),
                                  jp["layers"]["moe"]["router"][1])


def test_check_supported_admits_moe_with_gqa_and_mla():
    for arch in ARCHS:
        TM.check_supported(torch_cfg(arch))
        TM.check_supported(torch_smoke(arch))
    mla_moe = dataclasses.replace(torch_smoke("minicpm3-4b"),
                                  arch_type="moe", num_experts=4,
                                  top_k_experts=2)
    TM.check_supported(mla_moe)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(arch):
        if arch not in cache:
            jc = dataclasses.replace(jax_smoke(arch),
                                     dsa=JDSA(block_size=8, token_budget=32))
            tc = dataclasses.replace(torch_smoke(arch),
                                     dsa=TDSA(block_size=8, token_budget=32))
            jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                                   jc.num_layers, device="cpu")
            cache[arch] = (jc, tc, jp, tp)
        return cache[arch]
    return get


def _run(engine_cls, config_cls, request_cls, cfg, params, prompts=PROMPTS,
         arrivals=ARRIVALS, gen=GEN, **kw):
    eng = engine_cls(params, cfg, config_cls(**{"r_max": 4,
                                                "chunk_size": 64, **kw}))
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


def _both(setup, **kw):
    jc, tc, jp, tp = setup
    _, j_toks, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest, jc, jp,
                                   **kw)
    TF.moe_stats.reset()
    eng, t_toks, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                     tc, tp, **kw)
    assert t_toks == j_toks
    assert all(len(t) == kw.get("gen", GEN) for t in t_toks)
    assert t_stats == j_stats
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    # every MoE call read its counts back once and dropped no pair
    s = TF.moe_stats.snapshot()
    assert s["readbacks"] > 0 and s["dropped"] == 0
    assert sum(ops.launches.snapshot().values()) == 0
    return eng, t_stats


@pytest.mark.parametrize("hbm_blocks", [96, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_engine_matches_reference(arch, hbm_blocks, setups):
    eng, stats = _both(setups(arch), offload_quant="int8",
                       hbm_blocks_per_request=hbm_blocks)
    assert stats["h2d_calls"] > 0 and stats["d2h_calls"] > 0
    if hbm_blocks == 1:
        assert stats["evictions"] > 0
        assert eng.plane.blocks_restored_before_use > 0
    # the counts' read-backs are not plane host syncs: one per attention
    # layer per decode iteration, as the reference counts them
    assert eng.plane.host_syncs == eng.plane.steps * eng.cfg.num_layers


@pytest.mark.parametrize("path", ["legacy", "chunked"])
def test_prefill_oracle_matches_reference(path, setups):
    """The engine's two other prefills walk the layers themselves: the
    legacy executor (``prefill_layer``) and chunked prefill (32-token
    chunks over every layer), both drop-free, against the reference's."""
    kw = (dict(prefill_exec="legacy") if path == "legacy"
          else dict(prefill_mode="chunked", chunk_size=32))
    eng, _ = _both(setups("kimi-k2-1t-a32b"), hbm_blocks_per_request=1,
                   **kw)
    assert eng.prefill_launches == 0


def test_mixed_equals_split_under_one_block_lru(setups):
    """The reference's bar (tests/test_hybrid_plane.py, its MoE case)
    inside the port: prefill rides decode iterations under a 1-block
    LRU, mixed == split."""
    _, tc, _, tp = setups("kimi-k2-1t-a32b")
    kw = dict(prompts=(48, 96, 72, 40), arrivals=(0.0, 0.0, 0.005, 0.02),
              hbm_blocks_per_request=1, gen=3)
    e_m, toks_m, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                             **kw)
    e_s, toks_s, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                             hybrid_plane="split", **kw)
    assert toks_m == toks_s
    assert all(len(t) == 3 for t in toks_m)
    assert e_m.hybrid is not None and e_s.hybrid is None
    assert any(e["decode_rows"] > 0 and e["prefill_rows"] > 0
               for e in e_m.mixed_iter_log)
    assert e_s.plane.blocks_restored_before_use > 0


def test_plane_equals_legacy_equals_chunked(setups):
    _, tc, _, tp = setups("kimi-k2-1t-a32b")
    kw = dict(prompts=(48, 96, 72, 64), arrivals=(0.0,) * 4)
    toks = {name: _run(ServingEngine, EngineConfig, Request, tc, tp, **kw,
                       **extra)[1]
            for name, extra in (
                ("plane", {}), ("legacy", dict(prefill_exec="legacy")),
                ("chunked", dict(prefill_mode="chunked", chunk_size=32)))}
    assert toks["plane"] == toks["legacy"] == toks["chunked"]
    assert all(len(t) == GEN for t in toks["plane"])


def test_staged_equals_persistent_equals_stacked(setups):
    _, tc, _, tp = setups("kimi-k2-1t-a32b")
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


def test_int8_async_equals_sync(setups):
    _, tc, _, tp = setups("kimi-k2-1t-a32b")
    kw = dict(hbm_blocks_per_request=1, offload_quant="int8")
    e_a, toks_a, stats_a, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, **kw)
    e_s, toks_s, stats_s, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, stage_dispatch="sync", **kw)
    assert toks_a == toks_s
    assert stats_a == stats_s
    assert e_a.worker_jobs_run > 0 and e_s.worker_jobs_run == 0
