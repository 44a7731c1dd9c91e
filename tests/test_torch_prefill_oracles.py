"""The port's prefill oracles against the reference engine's on the same
submissions: the legacy layer-segmented executor
(``prefill_exec="legacy"``: one request's whole layer at a time, saved to
DRAM with one contiguous ``HostPool.save_contiguous`` per layer) and the
chunked-prefill baseline (``prefill_mode="chunked"``: every layer over a
chunk, attending to the earlier chunks' dense KV with ``q_offset``; the
paper's §3.4 baseline).  Both resolve to the split hybrid plane.

Sizes are ``test_torch_engine.py``'s: the qwen2 and llama3 smoke configs
with block 8 and budget 32, float32 on the CPU with the modelled clock, at
the default LRU and a 1-block LRU, the int8 tier on qwen2 at the default
LRU.  Greedy tokens, every ``TransferStats`` counter, the modelled
TTFT/TBT and the prefill HBM watermark (``prefill_hbm_peak_tokens``) must
equal the reference's.  Inside the port, on the fp tier: plane == legacy
== chunked, the reference's own bar."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
PATHS = {"legacy": dict(prefill_exec="legacy"),
         "chunked": dict(prefill_mode="chunked")}


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
         prompts=PROMPTS, arrivals=ARRIVALS, gen=GEN, **kw):
    kw.setdefault("chunk_size", 64)
    eng = engine_cls(params, cfg, config_cls(r_max=4, **kw))
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


@pytest.mark.parametrize("arch,hbm_blocks,quant", [
    ("qwen2-0.5b", 96, "none"), ("qwen2-0.5b", 1, "none"),
    ("llama3-8b", 96, "none"), ("llama3-8b", 1, "none"),
    ("qwen2-0.5b", 96, "int8")])
@pytest.mark.parametrize("path", ["legacy", "chunked"])
def test_prefill_oracle_matches_reference(path, arch, hbm_blocks, quant,
                                          setups):
    jc, tc, jp, tp = setups(arch)
    kw = dict(PATHS[path], hbm_blocks_per_request=hbm_blocks,
              offload_quant=quant)
    j_eng, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest,
                                         jc, jp, **kw)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp, **kw)
    assert eng.eng.hybrid_plane == "split"
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    # one contiguous save per (request, layer) and the decode write-back
    assert t_stats["d2h_calls"] > len(PROMPTS) * tc.num_layers
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.prefill_hbm_peak_tokens == j_eng.prefill_hbm_peak_tokens > 0
    # neither executor uses the batched prefill plane
    assert eng.prefill_launches == j_eng.prefill_launches == 0
    assert eng.admit_embed_launches == 0
    assert not eng.prefill_plane.rows


def test_plane_equals_legacy_equals_chunked(setups):
    """The reference's bar (tests/test_prefill_plane.py) inside the port:
    plane prefill, the legacy executor and chunked prefill (32-token
    chunks, so every prompt runs with context) give the same greedy tokens
    on four concurrent requests of mixed lengths; chunked holds every
    processed token of every layer, the layer-segmented modes one layer."""
    _, tc, _, tp = setups("qwen2-0.5b")
    kw = dict(prompts=(48, 96, 72, 64), arrivals=(0.0,) * 4)
    runs = {"plane": _run(ServingEngine, EngineConfig, Request, tc, tp,
                          **kw),
            "legacy": _run(ServingEngine, EngineConfig, Request, tc, tp,
                           prefill_exec="legacy", **kw),
            "chunked": _run(ServingEngine, EngineConfig, Request, tc, tp,
                            prefill_mode="chunked", chunk_size=32, **kw)}
    toks = {name: r[1] for name, r in runs.items()}
    assert toks["plane"] == toks["legacy"] == toks["chunked"]
    assert all(len(t) == GEN for t in toks["plane"])
    e_p, e_l, e_c = (runs[n][0] for n in ("plane", "legacy", "chunked"))
    assert e_p.eng.hybrid_plane == "mixed" and e_p.prefill_launches > 0
    assert e_l.prefill_launches == e_c.prefill_launches == 0
    assert (e_p.prefill_hbm_peak_tokens <= sum(kw["prompts"])
            < e_c.prefill_hbm_peak_tokens)
