"""MLA training (minicpm3-4b's smoke) in the port against the reference's,
on the CPU in float32: one train step's loss and every gradient leaf
against ``jax.value_and_grad`` of the reference's ``forward_train`` on the
same weights (through ``bridge.py``) and batch, three AdamW steps, remat
on and off, the eval step; the plain backward of ``flash_prefill`` at a
v width below the q/k depth (MLA's (96, 64) heads, here (24, 16))
against ``jax.grad`` of ``flash_attention_jnp`` and torch autograd of a
naive attention; and that every attention of the step reaches
``FlashPrefillFn`` causal.

Tolerances, as tests/test_torch_train.py's (float32 on both sides): the
backward within 1e-5 of each tensor's max |grad|; the loss within 1e-5
relative, every leaf's gradient within 1e-4 of its max |grad|, grad_norm
and lr within 1e-6 relative, three steps' losses within 1e-4 relative.
The reference's three steps are its ``value_and_grad`` and its
``adamw_update`` (each jitted once), the body of its
``make_train_step``.  The port
runs on one PyTorch thread (``one_thread``)."""
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
from repro.models.attention import flash_attention_jnp
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import init_opt_state as j_init_opt
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops
from repro_torch.training import trainer as TT
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.optimizer import tree_leaves

ARCH = "minicpm3-4b"
B, S, STEPS = 2, 32, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_steps(arch: str, batch_np: dict, steps: int, opt: dict,
                    **fields):
    """The reference's smoke weights (float32) as numpy, its first step's
    loss and gradients (``jax.value_and_grad`` of ``forward_train``,
    remat on) and ``steps`` steps' metrics (that gradient and
    ``adamw_update``, as its ``make_train_step`` runs them).  ``fields``
    replace the smoke config's on both sides (``port_setup``)."""
    jcfg = dataclasses.replace(jax_smoke(arch), **fields)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    vg = jax.jit(jax.value_and_grad(
        lambda p: JM.forward_train(p, jcfg, jbatch, remat=True)[0]))
    ocfg = JAdamWConfig(**opt)
    update = jax.jit(lambda p, g, s: j_adamw_update(ocfg, p, g, s))
    params, state, metrics = jp, j_init_opt(jp), []
    for i in range(steps):
        loss, grads = vg(params)
        if i == 0:
            loss0, grads0 = float(loss), grads
        params, state, om = update(params, grads, state)
        metrics.append({"loss": float(loss),
                        **{k: float(v) for k, v in om.items()}})
    n = jcfg.num_layers
    return dict(np_params=jax.tree.map(np.asarray, jp), n=n, loss0=loss0,
                fields=fields,
                grads=params_from_numpy(jax.tree.map(np.asarray, grads0), n,
                                        dtype=torch.float32),
                metrics=metrics)


def port_setup(arch: str, ref: dict, batch_np: dict):
    params = TT.trainable(params_from_numpy(ref["np_params"], ref["n"],
                                            dtype=torch.float32))
    cfg = dataclasses.replace(torch_smoke(arch), **ref.get("fields", {}))
    return cfg, params, TT.batch_to(batch_np, torch.device("cpu"))


def check_one_step(arch: str, ref: dict, batch_np: dict, opt: dict) -> dict:
    """One step of the port against the reference's: the loss, every
    gradient leaf, grad_norm and lr.  Returns the port's gradients by
    leaf path."""
    cfg, params, batch = port_setup(arch, ref, batch_np)
    loss, grads = TT.loss_and_grads(params, cfg, batch, remat=True)
    assert abs(loss.item() - ref["loss0"]) <= 1e-5 * abs(ref["loss0"])
    want = tree_leaves(ref["grads"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        bar = 1e-4 * w.abs().max().item()
        assert (g - w).abs().max().item() <= bar
    step = TT.make_train_step(cfg, AdamWConfig(**opt), remat=True)
    _, _, m = step(params, init_opt_state(params), batch)
    r = ref["metrics"][0]
    assert abs(m["loss"].item() - r["loss"]) <= 1e-5 * abs(r["loss"])
    for key in ("grad_norm", "lr"):
        assert abs(m[key].item() - r[key]) <= 1e-6 * abs(r[key]), key
    return grads


def check_steps(arch: str, ref: dict, batch_np: dict, opt: dict) -> None:
    cfg, params, batch = port_setup(arch, ref, batch_np)
    step = TT.make_train_step(cfg, AdamWConfig(**opt), remat=True)
    state = init_opt_state(params)
    for i, r in enumerate(ref["metrics"]):
        params, state, m = step(params, state, batch)
        assert abs(m["loss"].item() - r["loss"]) <= 1e-4 * abs(r["loss"]), i
    assert int(state["step"]) == len(ref["metrics"])


def check_remat(arch: str, ref: dict, batch_np: dict) -> None:
    cfg, params, batch = port_setup(arch, ref, batch_np)
    with_remat = TT.loss_and_grads(params, cfg, batch, remat=True)
    without = TT.loss_and_grads(params, cfg, batch, remat=False)
    assert with_remat[0].item() == without[0].item()
    for a, b in zip(with_remat[1], without[1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def causal_flags(monkeypatch, arch: str, ref: dict, batch_np: dict) -> list:
    """The ``causal`` flag of every ``FlashPrefillFn`` call of one train
    step, in call order (remat's reruns included)."""
    seen = []
    apply = ops.FlashPrefillFn.apply

    def spy(q, k, v, scale, causal):
        seen.append((causal, q.shape[1], k.shape[1], q.shape[-1],
                     v.shape[-1]))
        return apply(q, k, v, scale, causal)
    monkeypatch.setattr(ops.FlashPrefillFn, "apply", spy)
    cfg, params, batch = port_setup(arch, ref, batch_np)
    TT.loss_and_grads(params, cfg, batch, remat=False)
    return seen


@pytest.fixture(scope="module")
def batch_np():
    cfg = jax_smoke(ARCH)
    return JTokenStream(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=3)).batch()


@pytest.fixture(scope="module")
def ref(batch_np):
    return reference_steps(ARCH, batch_np, STEPS, OPT)


def test_one_train_step_matches_reference(ref, batch_np):
    """Every leaf, w_kr's included: k's rope part is one head broadcast
    over the query heads (``torch.cat`` of an expanded ``k_rope``, the
    reference's ``broadcast_to``), so its gradient is the sum over the
    heads."""
    grads = check_one_step(ARCH, ref, batch_np, OPT)
    cfg, params, _ = port_setup(ARCH, ref, batch_np)
    w_kr = params["layers"][0]["attn"]["w_kr"]
    at = next(i for i, t in enumerate(tree_leaves(params)) if t is w_kr)
    want = ref["grads"]["layers"][0]["attn"]["w_kr"]
    assert grads[at].abs().max() > 0
    assert (grads[at] - want).abs().max() <= 1e-4 * want.abs().max()


def test_three_steps_match_reference(ref, batch_np):
    check_steps(ARCH, ref, batch_np, OPT)


def test_remat_on_and_off_give_the_same_loss_and_gradients(ref, batch_np):
    check_remat(ARCH, ref, batch_np)


def test_eval_step_is_the_forward_loss(ref, batch_np):
    cfg, params, batch = port_setup(ARCH, ref, batch_np)
    loss = TT.make_eval_step(cfg)(params, batch)
    assert not loss.requires_grad
    assert abs(loss.item() - ref["loss0"]) <= 1e-5 * abs(ref["loss0"])


def test_every_attention_reaches_the_causal_function(monkeypatch, ref,
                                                     batch_np):
    cfg = torch_smoke(ARCH)
    m = cfg.mla
    seen = causal_flags(monkeypatch, ARCH, ref, batch_np)
    assert seen == [(True, S, S, m.qk_nope_head_dim + m.qk_rope_head_dim,
                     m.v_head_dim)] * cfg.num_layers


def _naive(q, k, v, scale, causal):
    """Attention written out, for torch autograd: GQA by repeating k and
    v, a causal mask over Sq == Sk when ``causal``."""
    G = q.shape[2] // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    if causal:
        n = q.shape[1]
        s = s.masked_fill(torch.triu(torch.ones(n, n, dtype=torch.bool), 1),
                          -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)


def check_plain_backward(Bn, Sq, Sk, Hq, Hkv, D, Dv, causal) -> None:
    """``ops.flash_prefill``'s gradient on the CPU (``FlashPrefillFn``'s
    plain forward and backward) against ``jax.grad`` of
    ``flash_attention_jnp`` and torch autograd of ``_naive``, each
    gradient within 1e-5 of its max |grad|."""
    rng = np.random.default_rng(Sq + Sk + D)
    q = rng.standard_normal((Bn, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bn, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bn, Sk, Hkv, Dv)).astype(np.float32)
    do = rng.standard_normal((Bn, Sq, Hq, Dv)).astype(np.float32)
    scale = D ** -0.5

    def jloss(q_, k_, v_):
        o = flash_attention_jnp(q_, k_, v_, scale=scale, causal=causal)
        return jnp.sum(o * do)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_prefill(tq, tk, tv, scale=scale, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    naive = torch.autograd.grad(_naive(tq, tk, tv, scale, causal),
                                (tq, tk, tv), torch.from_numpy(do))
    for g, w, n in zip(got, want, naive):
        w = np.asarray(w)
        bar = 1e-5 * np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= bar
        assert np.abs(g.numpy() - n.numpy()).max() <= bar


@pytest.mark.parametrize("Bn,Sn,Hq,Hkv,D,Dv", [
    (2, 37, 4, 4, 24, 16),      # MLA's shape in small: G 1, Dv < D
    (1, 600, 4, 4, 24, 16),     # past one 512-row chunk, ragged
    (1, 70, 6, 2, 24, 16)])     # and with a group
def test_plain_backward_at_a_v_width_below_the_depth(Bn, Sn, Hq, Hkv, D,
                                                     Dv):
    check_plain_backward(Bn, Sn, Sn, Hq, Hkv, D, Dv, causal=True)
