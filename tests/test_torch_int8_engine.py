"""The port's ServingEngine with the int8 DRAM offload tier
(``offload_quant="int8"``) against the reference's engine in the same
mode, on the same submissions: everything else default (mixed hybrid
plane, staged decode, layer-segmented plane prefill, async host stage, DSA
on), the qwen2 and llama3 smoke configs, at the default LRU capacity and
under a 1-block LRU (every selection misses, so the restores read what the
int8 save wrote).

Both sides run in float32 on the CPU with the modelled clock.  Greedy
tokens must be identical, and so must every ``TransferStats`` counter,
whose byte counters are at stored size (int8 payload plus scales).  The
pools' bytes themselves are compared in ``test_torch_quant.py``: here the
two frameworks' K/V stripes may differ in the last ulp, which can move an
int8 value.  Inside the port, the async host stage must equal the sync
oracle token for token and counter for counter."""
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
from repro_torch.kernels import ops
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4


@pytest.fixture(scope="module")
def setups():
    """The smoke configs with a reduced DSA (block 8, budget 32 -> top-4
    blocks, so selection drops blocks) and the reference's float32
    weights on both sides."""
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
def test_int8_engine_matches_reference(arch, hbm_blocks, setups):
    jc, tc, jp, tp = setups(arch)
    kw = dict(hbm_blocks_per_request=hbm_blocks, offload_quant="int8")
    _, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest, jc,
                                     jp, **kw)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp, **kw)
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    assert t_stats["h2d_calls"] > 0 and t_stats["d2h_calls"] > 0
    if hbm_blocks == 1:
        assert t_stats["evictions"] > 0
        assert eng.plane.blocks_restored_before_use > 0
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    # the modelled transfer time is charged at the tier's stored size
    assert eng.metrics_snapshot()["kv.offload_block_bytes"] == (
        2 * tc.num_kv_heads * (tc.dsa.block_size * tc.head_dim + 4))
    assert sum(ops.launches.snapshot().values()) == 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_int8_moves_fewer_wire_bytes_per_block_than_fp(arch, setups):
    """Per moved block, the int8 tier's wire bytes are at least 1.8x
    smaller than the fp tier's (its float32 pool: ~4x)."""
    _, tc, _, tp = setups(arch)
    per_block = {}
    for tier in ("none", "int8"):
        _, _, st, _ = _run(ServingEngine, EngineConfig, Request, tc, tp,
                           hbm_blocks_per_request=1, offload_quant=tier)
        per_block[tier] = ((st["h2d_bytes"] + st["d2h_bytes"])
                           / (st["h2d_blocks"] + st["d2h_blocks"]))
    assert per_block["none"] / per_block["int8"] >= 1.8


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_int8_async_equals_sync(arch, setups):
    _, tc, _, tp = setups(arch)
    runs = {mode: _run(ServingEngine, EngineConfig, Request, tc, tp,
                       hbm_blocks_per_request=1, offload_quant="int8",
                       stage_dispatch=mode)
            for mode in ("async", "sync")}
    e_a, toks_a, stats_a, _ = runs["async"]
    e_s, toks_s, stats_s, _ = runs["sync"]
    assert toks_a == toks_s
    assert stats_a == stats_s
    # on the CPU the int8 save runs on the host stage worker, like fp
    assert e_a.worker_jobs_run > 0 and e_s.worker_jobs_run == 0


def _run_stepwise(cfg, params, quant, prompts=(48, 48), gen=6):
    """The port's engine stepped by hand under a 1-block LRU, keeping the
    logits that produced each output token, so fidelity is comparable per
    position even after a greedy divergence (at the first divergent
    position both runs consumed the same tokens)."""
    eng = ServingEngine(params, cfg, EngineConfig(
        chunk_size=64, r_max=4, hbm_blocks_per_request=1,
        offload_quant=quant))
    rng = np.random.default_rng(7)
    order = []
    for p in prompts:
        r = Request(prompt_len=p, max_new_tokens=gen)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32))
        order.append(r.req_id)
    logits = {rid: {} for rid in order}
    while eng.step() is not None:
        for rid in order:
            st = eng.states[rid]
            if st.last_logits is None or not st.out_tokens:
                continue
            logits[rid].setdefault(len(st.out_tokens) - 1,
                                   st.last_logits.numpy().ravel().copy())
    eng.close()
    return (eng, [eng.states[rid].out_tokens for rid in order],
            [logits[rid] for rid in order])


def _cosine(a, b):
    return float(np.dot(a, b)
                 / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))


def test_int8_decode_fidelity_against_fp():
    """The reference's int8 fidelity bar (``tests/test_quant_kv.py``) in the
    port: under a 1-block LRU every selected block round-trips the DRAM
    tier each step, yet per-position logits keep cosine >= 0.99 against
    the fp tier up to and including the first greedy divergence, token 0
    never flips, and equal blocks move at >= 1.8x fewer wire bytes.
    Prints the worst cosine (``-s``)."""
    cfg = torch_smoke("qwen2-0.5b")
    jc = jax_smoke("qwen2-0.5b")
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                               device="cpu")
    eng_fp, toks_fp, log_fp = _run_stepwise(cfg, params, "none")
    eng_q8, toks_q8, log_q8 = _run_stepwise(cfg, params, "int8")
    worst = 1.0
    for tf, tq, lf, lq in zip(toks_fp, toks_q8, log_fp, log_q8):
        div = next((i for i, (a, b) in enumerate(zip(tf, tq)) if a != b),
                   len(tf) - 1)
        assert div >= 1                  # quant noise never flips token 0
        for i in range(div + 1):
            cos = _cosine(lf[i], lq[i])
            worst = min(worst, cos)
            assert cos >= 0.99, (i, div, cos)
    print(f"int8 vs fp worst per-position logits cosine: {worst:.6f}")
    ts_fp, ts_q8 = eng_fp.transfer_stats(), eng_q8.transfer_stats()
    assert ts_q8.h2d_bytes > 0 and ts_q8.d2h_bytes > 0
    assert ts_q8.h2d_blocks == ts_fp.h2d_blocks
    assert ts_q8.d2h_blocks == ts_fp.d2h_blocks
    wire_fp = ts_fp.h2d_bytes + ts_fp.d2h_bytes
    wire_q8 = ts_q8.h2d_bytes + ts_q8.d2h_bytes
    assert wire_fp / wire_q8 >= 1.8
    assert eng_q8._offload_block_bytes < eng_fp._offload_block_bytes / 1.8
