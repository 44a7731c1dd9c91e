"""The port's decode oracles against the reference engine's on the same
submissions: the fused persistent plane (``decode_plane="persistent"``,
restores landing after the forward that selected them), the stacked path
(``"stacked"``: every request's pools padded and concatenated each step)
and the sequential loop (``batched_decode=False``: one B=1 forward per
request).  Each resolves to the split hybrid plane and, by default, keeps
evicted blocks on the device.

Sizes are ``test_torch_engine.py``'s: the qwen2 and llama3 smoke configs
with block 8 and budget 32, float32 on the CPU with the modelled clock, at
the default LRU and a 1-block LRU; the persistent plane also on the int8
tier.  Greedy tokens, every ``TransferStats`` counter and the modelled
TTFT/TBT must equal the reference's.  Inside the port, on the fp tier:
staged == persistent == stacked, the reference's own bar."""
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
from repro_torch.models import model as M
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
PATHS = {"persistent": dict(decode_plane="persistent"),
         "stacked": dict(decode_plane="stacked"),
         "sequential": dict(batched_decode=False)}


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


@pytest.mark.parametrize("path,quant", [
    ("persistent", "none"), ("persistent", "int8"), ("stacked", "none"),
    ("sequential", "none")])
@pytest.mark.parametrize("hbm_blocks", [96, 1])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_decode_oracle_matches_reference(arch, hbm_blocks, path, quant,
                                         setups):
    jc, tc, jp, tp = setups(arch)
    kw = dict(PATHS[path], hbm_blocks_per_request=hbm_blocks,
              offload_quant=quant)
    j_eng, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest,
                                         jc, jp, **kw)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp, **kw)
    assert eng.eng.hybrid_plane == "split"
    assert not eng.eng.drop_evicted_device_blocks
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    assert t_stats["h2d_calls"] > 0
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.decode_step_calls == j_eng.decode_step_calls
    assert eng.stack_calls == j_eng.stack_calls
    if path == "stacked":
        assert eng.stack_calls == eng.decode_step_calls > 0
    else:
        assert eng.stack_calls == 0
    # only the persistent plane lands restores in device slots, after use
    restored = eng.plane.blocks_restored
    assert (restored > 0) == (path == "persistent")
    assert eng.plane.blocks_restored_before_use == 0


def test_staged_equals_persistent_equals_stacked(setups):
    """The reference's bar (tests/test_batched_decode.py) inside the port:
    the three batched decode paths give the same greedy tokens on mixed
    prompt lengths (so stacked pads pools of unequal block counts), with
    the same restore traffic under a 1-block LRU."""
    _, tc, _, tp = setups("qwen2-0.5b")
    kw = dict(prompts=(48, 96, 72), arrivals=(0.0, 0.0, 0.0), gen=5,
              hbm_blocks_per_request=1)
    runs = {name: _run(ServingEngine, EngineConfig, Request, tc, tp, **kw,
                       **extra)
            for name, extra in (("staged", dict(hybrid_plane="split")),
                                ("persistent", PATHS["persistent"]),
                                ("stacked", PATHS["stacked"]))}
    toks = {name: r[1] for name, r in runs.items()}
    assert toks["staged"] == toks["persistent"] == toks["stacked"]
    assert all(len(t) == 5 for t in toks["staged"])
    e_st, e_p, e_k = (runs[n][0] for n in ("staged", "persistent",
                                            "stacked"))
    assert e_st.stack_calls == e_p.stack_calls == 0
    assert e_k.stack_calls == e_k.decode_step_calls > 0
    # the staged plane drops and restores before use; the others never
    # lose a block
    assert e_st.plane.blocks_dropped > 0
    assert e_p.plane.blocks_dropped == e_k.plane.blocks_dropped == 0
    s = {n: runs[n][2] for n in runs}
    assert (s["staged"]["h2d_blocks"] == s["persistent"]["h2d_blocks"]
            == s["stacked"]["h2d_blocks"] > 0)
    assert s["staged"]["misses"] == s["stacked"]["misses"]


def test_plane_step_and_stacking_match_decode_step(setups):
    """``DevicePoolPlane.step`` over padded rows (one parked) and a
    stack / decode / unstack round trip over pools of unequal block counts
    give ``model.decode_step``'s logits on each request's own state;
    ``restore_blocks_fused`` lands one request's payload in its slots."""
    from repro_torch.core.device_pool import DevicePoolPlane
    _, tc, _, tp = setups("llama3-8b")
    rng = np.random.default_rng(3)
    states = []
    for S, nb in ((21, 4), (9, 6)):
        toks = torch.from_numpy(rng.integers(4, tc.vocab_size, (1, S))
                                .astype(np.int32))
        _, st = M.prefill(tp, tc, {"tokens": toks}, nb,
                          cache_dtype=torch.float32)
        states.append(st)

    def clone(st):
        return {"caches": [{k: v.clone() for k, v in c.items()}
                           for c in st["caches"]],
                "cur_len": st["cur_len"].clone(), "extra": {}}

    tok = torch.tensor([7], dtype=torch.int32)
    want = [M.decode_step(tp, tc, tok, clone(st))[0] for st in states]
    plane = DevicePoolPlane(tc)
    plane.admit("a", clone(states[0]))
    plane.admit("b", clone(states[1]))
    logits, info, prev = plane.step(tp, {"b": 7})
    np.testing.assert_allclose(logits[plane.rows["b"]].numpy(),
                               want[1][0].numpy(), atol=1e-5)
    assert prev == {"b": 9} and plane.cur_host == {"a": 21, "b": 10}
    assert sorted(info["selected"]) == list(range(tc.num_layers))
    batched, layout = M.stack_decode_states([clone(st) for st in states])
    assert batched["caches"][0]["k"].shape[2] == 6
    logits, new_state, _ = M.decode_step(
        tp, tc, torch.tensor([7, 7], dtype=torch.int32), batched,
        return_info=True)
    for i in range(2):
        np.testing.assert_allclose(logits[i].numpy(), want[i][0].numpy(),
                                   atol=1e-5)
    back = M.unstack_decode_states(new_state, layout)
    assert [int(s["cur_len"][0]) for s in back] == [22, 10]
    assert back[0]["caches"][0]["k"].shape[2] == 4
    payload = torch.ones((tc.num_kv_heads, 1, tc.dsa.block_size,
                          tc.head_dim))
    plane.restore_blocks_fused(0, {"a": ([2], payload, 2 * payload)})
    pool = plane.state["caches"][0]
    row = plane.rows["a"]
    assert torch.equal(pool["k"][row, :, 2:3], payload)
    assert torch.equal(pool["v"][row, :, 2:3], 2 * payload)
    assert plane.blocks_restored == 1
