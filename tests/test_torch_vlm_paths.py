"""internvl2-2b's oracle and baseline paths in the port against the
reference's, on the CPU: the engine's greedy tokens, ``TransferStats``
and modelled clock against the JAX ``ServingEngine`` on the same
submissions (patch embeddings included) on the stacked and sequential
decode paths, the legacy prefill executor and the chunked baseline,
which, as in the reference, embeds the prompt tokens only.  Setup as in
``test_torch_vlm.py``: the smoke config in float32 with the reference's
weights, block 8 and budget 32 so the selection drops blocks."""
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

ARCH = "internvl2-2b"
PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
PATHS = {
    "stacked": {"decode_plane": "stacked"},
    "sequential": {"batched_decode": False},
    "legacy": {"prefill_exec": "legacy"},
    "chunked": {"prefill_mode": "chunked"},
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
    for p, t in zip(PROMPTS, ARRIVALS):
        r = request_cls(prompt_len=p, max_new_tokens=GEN, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32),
                   patch_embeds=rng.standard_normal(
                       (1, cfg.num_patches, cfg.d_model)).astype(np.float32))
        ids.append(r.req_id)
    metrics = eng.run()
    return (eng, [eng.states[i].out_tokens for i in ids],
            dataclasses.asdict(eng.transfer_stats()), metrics)


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_matches_reference(path, pair):
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
    if path == "stacked":
        assert eng.stack_calls == j_eng.stack_calls > 0
