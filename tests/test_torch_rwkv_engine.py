"""rwkv6-1.6b's smoke on the port's serving engine against the reference's,
on the CPU: the engine's greedy tokens, ``TransferStats`` (zero: an
attention-free model caches no KV), modelled clock and prefill watermark
against the JAX ``ServingEngine`` on the same submissions, on the default
mixed walk and on every oracle and baseline path (the split plane, the
persistent, stacked and sequential decodes, the legacy prefill executor,
the chunked baseline, the int8 tier); the port's own equalities on RWKV
(mixed == split == sequential, staged == persistent == stacked, plane ==
legacy == chunked, int8 == fp); and the paths the reference's own tests
run for RWKV (``tests/test_engine.py``'s one-request engine at r_max 2,
``tests/test_consistency.py``'s state carry), each against the JAX
package.  The smoke runs in float32 with the reference's weights through
``bridge.py``; the port's side on one PyTorch thread (``one_thread``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import model as TM
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request
from test_torch_jamba_paths import one_thread  # noqa: F401

ARCH = "rwkv6-1.6b"
PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
PATHS = {
    "mixed": {},
    "split": {"hybrid_plane": "split"},
    "persistent": {"decode_plane": "persistent"},
    "stacked": {"decode_plane": "stacked"},
    "sequential": {"batched_decode": False},
    "legacy": {"prefill_exec": "legacy"},
    "chunked": {"prefill_mode": "chunked"},
    "int8": {"offload_quant": "int8"},
}
# tests/test_engine.py's engine on the arch families: r_max 2, one request
# of 64 prompt tokens and 4 new
REFERENCE_ENGINE = dict(prompts=(64,), arrivals=(0.0,), r_max=2)
ZERO_STATS = dict(h2d_bytes=0, h2d_calls=0, h2d_blocks=0, d2h_bytes=0,
                  d2h_calls=0, d2h_blocks=0, evictions=0, hits=0, misses=0)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, torch cfg, reference float32 params, the port's copy)."""
    jc, tc = jax_smoke(ARCH), torch_smoke(ARCH)
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                           device="cpu")
    return jc, tc, jp, tp


def _run(engine_cls, config_cls, request_cls, cfg, params, prompts=PROMPTS,
         arrivals=ARRIVALS, gen=GEN, r_max=4, **kw):
    eng = engine_cls(params, cfg, config_cls(r_max=r_max, chunk_size=64,
                                             **kw))
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


@pytest.fixture(scope="module")
def runs(pair):
    """Each path's (JAX run, port run), shared by the tests below."""
    jc, tc, jp, tp = pair
    cache = {}

    def get(path):
        if path not in cache:
            kw = (REFERENCE_ENGINE if path == "reference_engine"
                  else PATHS[path])
            cache[path] = (
                _run(JEngine, JEngineConfig, JRequest, jc, jp, **kw),
                _run(ServingEngine, EngineConfig, Request, tc, tp, **kw))
        return cache[path]
    return get


@pytest.mark.parametrize("path", list(PATHS) + ["reference_engine"])
def test_engine_matches_reference(path, runs):
    """Tokens, TransferStats (all zero), the modelled clock and the
    prefill watermark of the JAX engine, on each path."""
    (j_eng, j_tokens, j_stats, j_m), (eng, t_tokens, t_stats, t_m) = \
        runs(path)
    assert t_tokens == j_tokens
    assert all(len(t) == GEN for t in t_tokens)
    assert t_stats == j_stats == ZERO_STATS
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.prefill_hbm_peak_tokens == j_eng.prefill_hbm_peak_tokens


def test_port_equalities(runs):
    """The reference's equalities inside the port: mixed == split ==
    sequential, staged == persistent == stacked, plane == legacy ==
    chunked, and the int8 tier == fp (no KV to quantize)."""
    tok = {path: runs(path)[1][1] for path in PATHS}
    for group in (("mixed", "split", "sequential"),
                  ("mixed", "persistent", "stacked"),
                  ("mixed", "legacy", "chunked"), ("mixed", "int8")):
        assert all(tok[p] == tok["mixed"] for p in group), group


def test_decode_runs_no_select_and_no_host_stage(runs):
    """An attention-free decode step is recurrent stages only: the decode
    plane holds no pool and no pool table, no selected ids are copied to
    the host, a decode-only iteration runs no host stage, and a prefill
    iteration's host stages (one per layer with prefill groups) move no
    KV."""
    eng = runs("mixed")[1][0]
    assert eng.geom.num_layers == 1 and eng.geom.block_bytes == 0
    assert eng.plane.pool_table is None and eng.plane.host_syncs == 0
    assert all(not TM.is_pool_cache(c)
               for c in eng.plane.state["caches"])
    assert sorted(eng.plane.state["caches"][0]) == ["S", "shift_c",
                                                    "shift_t"]
    decode_only = [e for e in eng.mixed_iter_log
                   if e["decode_rows"] and not e["prefill_rows"]]
    assert decode_only and all(not e["layers"] for e in decode_only)
    stages = [lay for e in eng.mixed_iter_log for lay in e["layers"].values()]
    assert stages and all(lay["groups"] and not lay["decode"]
                          and lay["d2h"] == lay["h2d"] == 0
                          for lay in stages)


def test_state_carry_matches_reference(pair):
    """tests/test_consistency.py's RWKV check in the port: prefill of the
    first 64 tokens, then a decode step of the 65th, gives the logits of
    a prefill of all 65 (atol 5e-3, as there), and both equal the
    reference's prefill of 65 at the logit tolerance of
    ``test_torch_rwkv.py``."""
    jc, tc, jp, tp = pair
    toks = np.random.default_rng(1).integers(4, jc.vocab_size,
                                             65).astype(np.int32)
    nb = 65 // jc.dsa.block_size + 2
    j_full, _ = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks[None])}, nb,
                           cache_dtype=jnp.float32)
    t_full, _ = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks[None])},
                           nb, cache_dtype=torch.float32)
    _, state = TM.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[None, :-1])}, nb, cache_dtype=torch.float32)
    t_dec, _ = TM.decode_step(tp, tc, torch.from_numpy(toks[-1:]), state)
    np.testing.assert_allclose(t_dec.numpy(), t_full.numpy(), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full),
                               atol=1e-4)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_full),
                               atol=1e-4)
