"""whisper-small's sequential decode (one B = 1 forward per request,
each with its own encoder KV) and legacy prefill executor (one
request's whole layer at a time, the encoder run at its first segment)
in the port against the reference's, on the CPU.  Setup and checks as in
``test_torch_whisper_engine.py``."""
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

ARCH = "whisper-small"
PROMPTS = (48, 48, 64)
ENC_LENS = (16, 16, 24)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 3
PATHS = {
    "sequential": {"batched_decode": False},
    "legacy": {"prefill_exec": "legacy"},
}


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jax_smoke(ARCH),
                             dsa=JDSA(block_size=8, token_budget=32))
    tc = dataclasses.replace(torch_smoke(ARCH),
                             dsa=TDSA(block_size=8, token_budget=32))
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                           device="cpu")
    return jc, tc, jp, tp


def _run(engine_cls, config_cls, request_cls, cfg, params, **kw):
    eng = engine_cls(params, cfg, config_cls(r_max=4, chunk_size=64, **kw))
    rng = np.random.default_rng(7)
    ids = []
    for p, s_enc, t in zip(PROMPTS, ENC_LENS, ARRIVALS):
        r = request_cls(prompt_len=p, max_new_tokens=GEN, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32),
                   frames=(0.5 * rng.standard_normal(
                       (1, s_enc, cfg.d_model))).astype(np.float32))
        ids.append(r.req_id)
    metrics = eng.run()
    return (eng, [eng.states[i].out_tokens for i in ids],
            dataclasses.asdict(eng.transfer_stats()), metrics)


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_matches_reference(path, pair):
    """Greedy tokens, every TransferStats counter, the modelled clock and
    the planes made equal the JAX engine's."""
    jc, tc, jp, tp = pair
    kw = PATHS[path]
    j_eng, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest,
                                         jc, jp, **kw)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp, **kw)
    assert t_tokens == j_tokens
    assert all(len(t) == GEN for t in t_tokens)
    assert t_stats == j_stats
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.prefill_hbm_peak_tokens == j_eng.prefill_hbm_peak_tokens > 0
    assert len(eng.planes) == len(j_eng.planes)
    assert len(eng.prefill_planes) == len(j_eng.prefill_planes)
    assert sum(ops.launches.snapshot().values()) == 0
    if path == "legacy":
        assert eng.prefill_launches == j_eng.prefill_launches == 0
