"""The port's ServingEngine against the reference's on the same
submissions: default EngineConfig (mixed hybrid plane, staged decode,
layer-segmented plane prefill, async host stage, DSA on), the qwen2 and
llama3 smoke configs, at the default LRU capacity and under a 1-block LRU
(every selection misses, evicted blocks are zeroed on the device and must
be restored before use).

Both sides run in float32 on the CPU with the modelled clock, so the
scheduler makes the same decisions.  Greedy tokens must be identical, and
so must every ``TransferStats`` counter (h2d/d2h calls, blocks and bytes,
hits, misses, evictions).  A reduced DSA config (block 8, budget 32 ->
top-4 blocks) makes selection drop blocks.  Inside the port, the async
host stage must equal the sync oracle token for token."""
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
from repro_torch.kernels import ops
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4


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


def _run(engine_cls, config_cls, request_cls, cfg, params, **kw):
    eng = engine_cls(params, cfg, config_cls(r_max=4, chunk_size=64, **kw))
    rng = np.random.default_rng(7)
    ids = []
    for p, t in zip(PROMPTS, ARRIVALS):
        r = request_cls(prompt_len=p, max_new_tokens=GEN, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32))
        ids.append(r.req_id)
    metrics = eng.run()
    return (eng, [eng.states[i].out_tokens for i in ids],
            dataclasses.asdict(eng.transfer_stats()), metrics)


@pytest.mark.parametrize("hbm_blocks", [96, 1])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_engine_matches_reference(arch, hbm_blocks, setups):
    jc, tc, jp, tp = setups(arch)
    _, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest, jc,
                                     jp, hbm_blocks_per_request=hbm_blocks)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp,
                                       hbm_blocks_per_request=hbm_blocks)
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    assert t_stats["h2d_calls"] > 0 and t_stats["d2h_calls"] > 0
    if hbm_blocks == 1:
        assert t_stats["evictions"] > 0
        assert eng.plane.blocks_dropped > 0
        assert eng.plane.blocks_restored_before_use > 0
    # the same modelled clock: same TTFT/TBT as the reference
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    # one selected-id sync per attention layer per decode iteration
    assert eng.plane.host_syncs == eng.plane.steps * tc.num_layers
    # CPU tensors take the plain versions: no kernel launch is counted
    assert sum(ops.launches.snapshot().values()) == 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_async_equals_sync(arch, setups):
    _, tc, _, tp = setups(arch)
    e_a, toks_a, stats_a, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, hbm_blocks_per_request=1)
    e_s, toks_s, stats_s, _ = _run(ServingEngine, EngineConfig, Request, tc,
                                   tp, hbm_blocks_per_request=1,
                                   stage_dispatch="sync")
    assert toks_a == toks_s
    assert stats_a == stats_s
    assert e_a.worker_jobs_run > 0 and e_s.worker_jobs_run == 0


@pytest.mark.parametrize("field,value", [
    ("decode_plane", "persistent"), ("decode_plane", "stacked"),
    ("hybrid_plane", "split"), ("prefill_exec", "legacy"),
    ("prefill_mode", "chunked"), ("offload_quant", "int8"),
    ("mesh_spec", "model=2"), ("obs", True), ("batched_decode", False)])
def test_unported_options_raise(field, value, setups):
    _, tc, _, tp = setups("qwen2-0.5b")
    with pytest.raises(NotImplementedError):
        ServingEngine(tp, tc, EngineConfig(**{field: value}))


def test_unknown_option_value_raises(setups):
    _, tc, _, tp = setups("qwen2-0.5b")
    with pytest.raises(ValueError):
        ServingEngine(tp, tc, EngineConfig(stage_dispatch="eager"))
    assert EngineConfig().stage_dispatch == "async"
    assert not hasattr(EngineConfig(), "attn_impl")
    # the caller's config is not mutated by resolution
    cfg = EngineConfig()
    ServingEngine(tp, tc, cfg)
    assert cfg.drop_evicted_device_blocks is None


def test_device_pool_plane_staged_step_matches_decode_step(setups):
    """``DevicePoolPlane.step_staged`` over padded rows (one parked) gives
    the logits of ``model.decode_step`` on the unpadded state, and its row
    block helpers round-trip."""
    from repro_torch.core.device_pool import (DevicePoolPlane,
                                              gather_row_blocks,
                                              scatter_row_blocks)
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    _, tc, _, tp = setups("llama3-8b")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        4, tc.vocab_size, (1, 21)).astype(np.int32))
    _, st = M.prefill(tp, tc, {"tokens": toks}, 4, cache_dtype=torch.float32)
    plane = DevicePoolPlane(tc)
    for rid in ("a", "b"):
        plane.admit(rid, {"caches": [{k: v.clone() for k, v in c.items()}
                                     for c in st["caches"]],
                          "cur_len": st["cur_len"].clone(), "extra": {}})
    seen = []
    logits, info, prev = plane.step_staged(
        tp, {"b": 7}, lambda layer, sel, prev: seen.append(layer))
    want, _ = M.decode_step(tp, tc, torch.tensor([7], dtype=torch.int32), st)
    np.testing.assert_allclose(logits[plane.rows["b"]].numpy(),
                               want[0].numpy(), atol=1e-5)
    assert seen == list(range(tc.num_layers)) and prev == {"b": 21}
    assert plane.cur_host == {"a": 21, "b": 22}
    pool = plane.state["caches"][0]["k"]
    blk = gather_row_blocks(pool, 1, [2, 0])
    scatter_row_blocks(pool, 0, [3, 1], blk)
    assert torch.equal(gather_row_blocks(pool, 0, [3, 1]), blk)
    padded = A.pad_pool_cache(st["caches"][0], 6)
    assert padded["k"].shape[2] == 6 and not padded["k"][:, :, 4:].any()
    assert torch.equal(A.slice_pool_cache(padded, 4)["v"],
                       st["caches"][0]["v"])
