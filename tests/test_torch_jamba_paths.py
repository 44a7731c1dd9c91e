"""jamba-v0.1-52b's smoke on the oracle and baseline paths, in the port
against the reference, on the CPU: the engine's greedy tokens,
``TransferStats``, modelled clock and prefill watermark against the JAX
``ServingEngine`` on the same submissions on the split plane, the
persistent, stacked and sequential decodes, the legacy prefill executor
and the chunked baseline (which carries each Mamba layer's state over
the chunks).  Setup as in ``test_torch_jamba.py``: the smoke in float32
with the reference's weights, block 8 and budget 32 so the selection
drops blocks; the 8-layer interleave's paths are in
``test_torch_jamba_interleave.py``.  The port's side runs on one
PyTorch thread (``one_thread``, used by every Jamba test module)."""
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
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

ARCH = "jamba-v0.1-52b"
PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
PATHS = {
    "split": {"hybrid_plane": "split"},
    "persistent": {"decode_plane": "persistent"},
    "stacked": {"decode_plane": "stacked"},
    "sequential": {"batched_decode": False},
    "legacy": {"prefill_exec": "legacy"},
    "chunked": {"prefill_mode": "chunked"},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's PyTorch ops on one thread, the count restored after:
    these engines run thousands of small ops (the plain scan steps token
    by token), and under the suite's parallel workers an 8-thread pool
    per process spends minutes where one thread takes a second."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**layout):
    """The smoke (with ``layout`` over it) for both packages, block 8 and
    budget 32."""
    return tuple(dataclasses.replace(
        smoke(ARCH), dsa=type(smoke(ARCH).dsa)(block_size=8,
                                                token_budget=32), **layout)
        for smoke in (jax_smoke, torch_smoke))


@pytest.fixture(scope="module")
def pair():
    jc, tc = configs()
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                           device="cpu")
    return jc, tc, jp, tp


def run(engine_cls, config_cls, request_cls, cfg, params, **kw):
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


def check_path(path, pair):
    """The port's run of ``path`` against the reference's."""
    jc, tc, jp, tp = pair
    kw = PATHS[path]
    j_eng, j_tokens, j_stats, j_m = run(JEngine, JEngineConfig, JRequest,
                                        jc, jp, **kw)
    eng, t_tokens, t_stats, t_m = run(ServingEngine, EngineConfig, Request,
                                      tc, tp, **kw)
    assert t_tokens == j_tokens
    assert all(len(t) == GEN for t in t_tokens)
    assert t_stats == j_stats
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.prefill_hbm_peak_tokens == j_eng.prefill_hbm_peak_tokens > 0
    if path == "stacked":
        assert eng.stack_calls == j_eng.stack_calls > 0
    if path == "persistent":
        assert (sum(p.blocks_restored for p in eng.planes.values())
                == sum(p.blocks_restored for p in j_eng.planes.values()))


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_matches_reference(path, pair):
    check_path(path, pair)
