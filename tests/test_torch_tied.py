"""Tied embeddings in the port against the reference: qwen2-0.5b's smoke
with ``tie_embeddings=True`` on both sides (``dataclasses.replace``: no
config of the registry ties its embeddings), the reference's float32
weights through ``bridge.py``.

- No ``lm_head`` leaf: not in the port's ``init_params``, not in the
  reference's, not in the bridged pytree; the head is ``embed.T``.
- Prefill and decode logits against the reference at the model tests'
  atol 1e-4 (``tests/test_torch_model.py``), greedy tokens under teacher
  forcing, a reduced DSA (block 8, top-4 blocks) so selection drops
  blocks.
- The engine's greedy tokens and ``TransferStats`` equal to the
  reference ``ServingEngine``'s (``tests/test_torch_engine.py``'s
  submissions).
- One train step against the reference's ``make_train_step``: the loss
  within 1e-5 relative, every gradient leaf within 1e-4 of its max
  |grad| (``embed``'s gets both uses), ``grad_norm`` within 1e-6
  relative (``tests/test_torch_train.py``'s bars)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro.training import trainer as JT
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import init_opt_state as j_init_opt
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import model as TM
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request
from repro_torch.training import trainer as TT
from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                            tree_leaves)

ARCH = "qwen2-0.5b"
LOGIT_ATOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=1)


def _tied(cfg, dsa=None):
    cfg = dataclasses.replace(cfg, tie_embeddings=True)
    return cfg if dsa is None else dataclasses.replace(cfg, dsa=dsa)


@pytest.fixture(scope="module")
def pair():
    jc = _tied(jax_smoke(ARCH), JDSA(block_size=8, token_budget=32))
    tc = _tied(torch_smoke(ARCH), TDSA(block_size=8, token_budget=32))
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, np_params, params_from_numpy(np_params,
                                                     jc.num_layers)


def test_no_lm_head_leaf(pair):
    jc, tc, jp, _, tp = pair
    assert "lm_head" not in jp and "lm_head" not in tp
    own = TM.init_params(tc, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    assert "lm_head" not in own
    h = torch.randn((2, 3, tc.d_model))
    torch.testing.assert_close(
        TM.lm_head(own, tc, h),
        TM._norm(tc, own["final_norm"], h) @ own["embed"].T)
    untied = TM.init_params(torch_smoke(ARCH), torch.Generator(),
                            device="cpu")
    assert untied["lm_head"].shape == (tc.d_model, tc.vocab_size)


def test_prefill_and_decode_logits_match(pair):
    jc, tc, jp, _, tp = pair
    r = np.random.default_rng(1)
    S, steps, nb = 37, 4, 8
    toks = r.integers(4, jc.vocab_size, (2, S)).astype(np.int32)
    jl, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, nb,
                         cache_dtype=jnp.float32)
    tl, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, nb,
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    step = jax.jit(lambda p, t, s: JM.decode_step(p, jc, t, s))
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        assert (np.argmax(tl.numpy(), axis=-1) == nxt).all()
        jl, jst = step(jp, jnp.asarray(nxt), jst)
        tl, tst = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)


def _serve(engine_cls, config_cls, request_cls, cfg, params):
    eng = engine_cls(params, cfg, config_cls(r_max=4, chunk_size=64,
                                             hbm_blocks_per_request=1))
    rng = np.random.default_rng(7)
    ids = []
    for p, t in zip((48, 64, 72), (0.0, 1e-4, 3e-3)):
        r = request_cls(prompt_len=p, max_new_tokens=4, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32))
        ids.append(r.req_id)
    eng.run()
    return ([eng.states[i].out_tokens for i in ids],
            dataclasses.asdict(eng.transfer_stats()))


def test_engine_tokens_match_reference(pair):
    jc, tc, jp, _, tp = pair
    j_tokens, j_stats = _serve(JEngine, JEngineConfig, JRequest, jc, jp)
    t_tokens, t_stats = _serve(ServingEngine, EngineConfig, Request, tc, tp)
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    assert t_stats["evictions"] > 0


def test_one_train_step_matches_reference(pair):
    jc, tc, jp, np_params, _ = pair
    raw = JTokenStream(JDataConfig(vocab_size=jc.vocab_size, seq_len=48,
                                   global_batch=2, seed=3)).batch()
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    loss0, jgrads = jax.value_and_grad(
        lambda p: JM.forward_train(p, jc, jbatch, remat=True)[0])(jp)
    _, _, jm = jax.jit(JT.make_train_step(jc, JAdamWConfig(**OPT), True))(
        jp, j_init_opt(jp), jbatch)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads),
                                         jc.num_layers, dtype=torch.float32))

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = TT.trainable(params_from_numpy(np_params, jc.num_layers,
                                                dtype=torch.float32))
        batch = TT.batch_to(raw, torch.device("cpu"))
        loss, grads = TT.loss_and_grads(params, tc, batch, remat=True)
        _, _, m = TT.make_train_step(tc, AdamWConfig(**OPT), remat=True)(
            params, init_opt_state(params), batch)
    finally:
        torch.set_num_threads(n)
    assert abs(loss.item() - float(loss0)) <= 1e-5 * abs(float(loss0))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    ref = {k: float(v) for k, v in jm.items()}
    assert abs(m["loss"].item() - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(m["grad_norm"].item() - ref["grad_norm"]) <= \
        1e-6 * abs(ref["grad_norm"])
