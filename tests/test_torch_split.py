"""The port's split hybrid plane (``hybrid_plane="split"``: the prefill
plane's own iteration, then the staged decode plane's) against the
reference engine's split path on the same submissions, and the
reference's own bar inside the port: mixed == split == sequential.

Sizes are ``test_torch_engine.py``'s: the qwen2 and llama3 smoke configs
with block 8 and budget 32 (top-4 blocks), float32 on the CPU with the
modelled clock, at the default LRU and under a 1-block LRU, on the fp and
the int8 tier.  Greedy tokens and every ``TransferStats`` counter must be
equal, and so must the modelled TTFT and TBT (the split path charges the
staged decode's overlapped time plus the prefill groups')."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
# the reference's mixed == split == sequential workload
# (tests/test_hybrid_plane.py): later arrivals land mid-decode of the first
# rows, so some iterations carry decode rows and prefill segments together
STAGGER_PROMPTS = (48, 96, 72, 64)
STAGGER = (0.0, 0.0, 1e-4, 3e-3)


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


def _run(engine_cls, config_cls, request_cls, cfg, params,
         prompts=PROMPTS, arrivals=ARRIVALS, gen=GEN, probe=None, **kw):
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


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("hbm_blocks", [96, 1])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_split_matches_reference(arch, hbm_blocks, quant, setups):
    jc, tc, jp, tp = setups(arch)
    kw = dict(hybrid_plane="split", hbm_blocks_per_request=hbm_blocks,
              offload_quant=quant)
    j_eng, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest,
                                         jc, jp, **kw)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp, **kw)
    assert eng.hybrid is None and eng.eng.hybrid_plane == "split"
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    assert t_stats["h2d_calls"] > 0 and t_stats["d2h_calls"] > 0
    assert eng.prefill_launches == j_eng.prefill_launches > 0
    assert eng.prefill_hbm_peak_tokens == j_eng.prefill_hbm_peak_tokens
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    if hbm_blocks == 1:
        assert eng.plane.blocks_dropped > 0
        assert eng.plane.blocks_restored_before_use > 0


@pytest.fixture(scope="module")
def staggered(setups):
    """Mixed (default) / split / sequential decode in the port over the
    reference's staggered 4-request workload with 32-token segments."""
    _, tc, _, tp = setups("qwen2-0.5b")
    kw = dict(prompts=STAGGER_PROMPTS, arrivals=STAGGER,
              prefill_max_tokens_per_step=32)
    return {name: _run(ServingEngine, EngineConfig, Request, tc, tp,
                       **kw, **extra)
            for name, extra in (("mixed", {}),
                                ("split", dict(hybrid_plane="split")),
                                ("sequential", dict(batched_decode=False)))}


def test_mixed_equals_split_equals_sequential(staggered):
    e_m, toks_m, _, _ = staggered["mixed"]
    e_s, toks_s, stats_s, _ = staggered["split"]
    e_q, toks_q, _, _ = staggered["sequential"]
    assert toks_m == toks_s == toks_q
    assert all(len(t) == GEN for t in toks_m)
    # not vacuous: some mixed iteration carried decode and prefill rows
    assert any(e["decode_rows"] > 0 and e["prefill_rows"] > 0
               for e in e_m.mixed_iter_log)
    assert len(e_m.mixed_iter_log) == e_m.iterations
    # the split and sequential paths really ran without the mixed walk
    assert e_s.hybrid is None and e_s.mixed_iter_log == []
    assert e_q.eng.hybrid_plane == "split" and e_q.plane.steps == 0
    assert e_s.plane.steps > 0
    assert stats_s["h2d_calls"] > 0
    # the 96-token prompt's layers really ran in 32-token chunks
    assert e_s.prefill_launches > e_s.cfg.num_layers * 2


def test_split_async_equals_sync(setups):
    _, tc, _, tp = setups("llama3-8b")
    kw = dict(hybrid_plane="split", hbm_blocks_per_request=1)
    e_a, toks_a, stats_a, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, **kw)
    e_s, toks_s, stats_s, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, stage_dispatch="sync", **kw)
    assert toks_a == toks_s
    assert stats_a == stats_s
    assert e_a.worker_jobs_run > 0 and e_s.worker_jobs_run == 0


def test_split_restores_land_before_use(setups):
    """Under a 1-block LRU on the split path, every block an attention is
    about to read equals its host copy in the restore -> attend window of
    every layer of every decode step; in particular no attended block is
    a dropped zero block while its host copy holds data."""
    _, tc, _, tp = setups("qwen2-0.5b")
    checked = [0]

    def probe(engine, plane, layer, sts, blocks_by_req):
        c = plane.state["caches"][layer]
        for st in sts:
            rid = st.req.req_id
            row = plane.rows[rid]
            host = engine.kv_mgr.pools[rid]
            for b in blocks_by_req[rid]:
                dev_k = c["k"][row, :, b]
                assert torch.equal(dev_k, host.k[layer, :, b]), (layer, b)
                if host.k[layer, :, b].any():
                    assert dev_k.any(), (layer, b)
                assert torch.equal(c["v"][row, :, b], host.v[layer, :, b])
                checked[0] += 1

    eng, toks, _, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                           prompts=(64, 64), arrivals=(0.0, 0.0), gen=6,
                           probe=probe, hybrid_plane="split",
                           hbm_blocks_per_request=1)
    assert eng.eng.drop_evicted_device_blocks
    assert checked[0] > 0
    assert eng.plane.blocks_dropped > 0
    assert all(len(t) == 6 for t in toks)
