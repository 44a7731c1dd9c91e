"""MoE and hybrid training in the port against the reference's, on the CPU
in float32, at the smoke configs: kimi-k2-1t-a32b (2 MoE layers),
arctic-480b (2 MoE layers with the dense residual) and jamba-v0.1-52b (a
Mamba layer with a dense FFN, then an attention layer with the MoE).
One train step's loss (the cross-entropy plus 0.01 x the MoE layers'
aux loss) and every gradient leaf (the router, the experts, Mamba's
A_log, dt_bias and D among them) against ``jax.value_and_grad`` of the
reference's ``forward_train`` on the same weights (through
``bridge.py``) and batch, three AdamW steps, remat on and off, the eval
step; a capacity small enough that pairs are dropped, on both sides;
that every Mamba layer of a step runs its scan through
``ops.SelectiveScanFn`` (the serve's ``ops.selective_scan`` never) and
that ``moe_stats`` counts each layer's MoE call once under remat; and
the plain backward of the selective scan, ``ref.selective_scan_bwd``,
against ``jax.grad`` of a ``lax.scan`` of the reference's ``_ssm_scan``
and against torch autograd of a differentiable token loop, from a
non-zero state with a non-zero final state's gradient, over
right-padded rows (dt = 0) and at large dt |A|.

Tolerances are tests/test_torch_train_rwkv.py's (float32 on both sides):
the loss within 1e-5 relative, every leaf's gradient within 1e-4 of its
max |grad|, grad_norm and lr within 1e-6 relative, three steps' losses
within 1e-4 relative; the plain backward within 1e-5 of each gradient's
max |grad| (the same products summed in another order).  The chunked
backward, kernel D's algebra, is held against ``ref.selective_scan_bwd``
in tests/test_torch_scan_chunks.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models.mamba import _ssm_scan
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import model as TM
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import trainer as TT
from repro_torch.training.optimizer import AdamWConfig
from test_torch_train_mla import (check_one_step, check_remat, check_steps,
                                  one_thread, port_setup, reference_steps)

ARCHS = ("kimi-k2-1t-a32b", "arctic-480b", "jamba-v0.1-52b")
B, S, STEPS = 2, 20, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
# kimi-k2's smoke with this capacity factor keeps 4 pairs an expert (the
# least moe_capacity gives) of the 80 its 40 tokens route to 4 experts
SMALL_CAPACITY = 0.1

assert one_thread   # the port on one PyTorch thread here too (autouse)


def _batch(arch: str) -> dict:
    cfg = jax_smoke(arch)
    return JTokenStream(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=3)).batch()


@pytest.fixture(scope="module")
def batches():
    return {arch: _batch(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def references(batches):
    return {arch: reference_steps(arch, batches[arch], STEPS, OPT)
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch, references, batches):
    """Every leaf: the router through the softmax, the renormalised gates
    and the aux loss; each expert's SwiGLU; arctic's dense residual;
    jamba's Mamba projections, A_log (through A = -exp(A_log)), dt_bias
    and D."""
    grads = check_one_step(arch, references[arch], batches[arch], OPT)
    cfg, params, _ = port_setup(arch, references[arch], batches[arch])
    leaves = TT.tree_leaves(params)
    named = {"router"} | ({"A_log", "dt_bias", "D"}
                          if cfg.arch_type == "hybrid" else set())
    for i, layer in enumerate(params["layers"]):
        for group in ("moe", "mamba"):
            for name, t in layer.get(group, {}).items():
                if name in named:
                    at = next(j for j, x in enumerate(leaves) if x is t)
                    assert grads[at].abs().max() > 0, (i, group, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference(arch, references, batches):
    check_steps(arch, references[arch], batches[arch], OPT)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_loss_and_gradients(arch, references,
                                                           batches):
    check_remat(arch, references[arch], batches[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_is_the_forward_loss(arch, references, batches):
    cfg, params, batch = port_setup(arch, references[arch], batches[arch])
    loss = TT.make_eval_step(cfg)(params, batch)
    assert not loss.requires_grad
    want = references[arch]["loss0"]
    assert abs(loss.item() - want) <= 1e-5 * abs(want)


def test_dropped_pairs_match_reference(batches):
    """A capacity of 4 pairs an expert on both sides: the step drops
    pairs (``moe_stats``) and its loss and gradients still match."""
    arch = "kimi-k2-1t-a32b"
    reference = reference_steps(arch, batches[arch], 1, OPT,
                                capacity_factor=SMALL_CAPACITY)
    ffn_mod.moe_stats.reset()
    check_one_step(arch, reference, batches[arch], OPT)
    stats = ffn_mod.moe_stats.snapshot()
    assert stats["dropped"] > 0 and stats["pairs"] > stats["dropped"]


def test_moe_calls_are_counted_once_under_remat(references, batches):
    """Remat reruns each layer's forward on the backward pass; the MoE
    call of that rerun is not counted: one read-back and B x S x k pairs
    per MoE layer, remat on or off."""
    arch = "kimi-k2-1t-a32b"
    cfg, params, batch = port_setup(arch, references[arch], batches[arch])
    seen = []
    for remat in (True, False):
        ffn_mod.moe_stats.reset()
        TT.loss_and_grads(params, cfg, batch, remat=remat)
        seen.append(ffn_mod.moe_stats.snapshot())
    n = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert seen[0] == seen[1]
    assert seen[0]["readbacks"] == n
    assert seen[0]["pairs"] == n * B * S * cfg.top_k_experts
    assert "_paused" not in seen[0]


def test_every_mamba_layer_reaches_the_training_scan(monkeypatch, references,
                                                     batches):
    """One SelectiveScanFn call a Mamba layer on a step without remat,
    over the whole window from a zero state, and none of the serve's
    selective_scan."""
    arch = "jamba-v0.1-52b"
    seen, served = [], []
    apply, serve = ops.SelectiveScanFn.apply, ops.selective_scan

    def spy(x, dt, Bm, Cm, A, D, h0):
        seen.append((tuple(x.shape), bool(h0.abs().max() == 0)))
        return apply(x, dt, Bm, Cm, A, D, h0)

    def spy_serve(*args):
        served.append(1)
        return serve(*args)
    monkeypatch.setattr(ops.SelectiveScanFn, "apply", spy)
    monkeypatch.setattr(ops, "selective_scan", spy_serve)
    cfg, params, batch = port_setup(arch, references[arch], batches[arch])
    TT.loss_and_grads(params, cfg, batch, remat=False)
    di = cfg.mamba_expand * cfg.d_model
    n = sum(TM.layer_kind(cfg, i) == "mamba" for i in range(cfg.num_layers))
    assert n and seen == [((B, S, di), True)] * n
    assert not served


def test_eval_step_keeps_the_float32_leaves_float32():
    """The eval step's cast to bfloat16 (the card's), one layer at a
    time, keeps the MoE router and Mamba's dt_bias, A_log and D float32,
    as the serve holds them."""
    cfg = torch_smoke("jamba-v0.1-52b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, device="cpu")
    layers = TT._CastLayers(params["layers"], torch.bfloat16)
    mamba, moe = layers[0]["mamba"], layers[1]["moe"]
    for name, t in mamba.items():
        assert t.dtype == (torch.float32 if name in ("dt_bias", "A_log", "D")
                           else torch.bfloat16), name
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    assert params["layers"][0]["mamba"]["in_proj"].dtype == torch.float32


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_but_tied_embeddings_trains(arch):
    """Every config of the registry and its smoke pass ``check_trainable``
    and build a train step; since tied embeddings are served
    (tests/test_torch_tied.py holds a tied step against the reference),
    each smoke with ``tie_embeddings`` passes and builds one too, and its
    parameters have no ``lm_head`` leaf."""
    TM.check_trainable(get_config(arch))
    TT.make_train_step(torch_smoke(arch), AdamWConfig())
    tied = dataclasses.replace(torch_smoke(arch), tie_embeddings=True)
    TM.check_trainable(tied)
    TT.make_train_step(tied, AdamWConfig())
    assert "lm_head" not in TM.init_params(tied, torch.Generator(),
                                           device="cpu")


def test_adamw_updates_a_large_leaf_a_slice_at_a_time(monkeypatch):
    """AdamW over leaves cut into slices (UPDATE_SLICE made 7 elements,
    so a leaf of 40 is six slices, the last ragged) gives the whole-leaf
    update's params and moments bit for bit, a non-contiguous grad read
    as it is; a non-contiguous param is refused."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((5, 8), generator=gen),
              "b": torch.randn((3,), generator=gen)}
    grads = {"w": torch.randn((8, 5), generator=gen).t(),
             "b": torch.randn((3,), generator=gen)}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    runs = []
    for size in (1 << 24, 7):
        monkeypatch.setattr(opt_mod, "UPDATE_SLICE", size)
        p = {k: t.clone() for k, t in params.items()}
        state = opt_mod.init_opt_state(p)
        for _ in range(2):
            opt_mod.adamw_update(cfg, p, grads, state)
        runs.append(opt_mod.tree_leaves(p) + opt_mod.tree_leaves(state["m"])
                    + opt_mod.tree_leaves(state["v"]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not any(torch.equal(a, b) for a, b in zip(
        runs[0], opt_mod.tree_leaves(params)))
    p = {"w": params["w"].t(), "b": params["b"]}
    with pytest.raises(ValueError, match="contiguous"):
        opt_mod.adamw_update(cfg, p, {"w": grads["w"].t(), "b": grads["b"]},
                             opt_mod.init_opt_state(p))


# ---------------------------------------------------------------------------
# The plain backward of the selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(Bn, Sn, di, lens, dt_shift, seed):
    """numpy operands: x, B, C ~ N(0, 1), dt = softplus(N(shift, 1))
    zeroed past each row's length, A = -exp(log(1..16) + N(0, 0.1^2)), D
    = 1 + N(0, 0.1^2), h0, dy and dh ~ N(0, 1)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    mask = np.arange(Sn)[None, :] < np.asarray(lens)[:, None]
    dt = (np.logaddexp(0, randn(Bn, Sn, di) + dt_shift)
          * mask[..., None]).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, 17, dtype=np.float32))
                + 0.1 * randn(di, 16)).astype(np.float32)
    return dict(x=randn(Bn, Sn, di), dt=dt, B=randn(Bn, Sn, 16),
                C=randn(Bn, Sn, 16), A=A, D=1 + 0.1 * randn(di),
                h0=randn(Bn, di, 16), dy=randn(Bn, Sn, di),
                dh=randn(Bn, di, 16))


NAMES = ("x", "dt", "B", "C", "A", "D", "h0")


def _jax_grads(a):
    """jax.grad of sum(y dy) + sum(h_final dh) through the reference's
    _ssm_scan (a lax.scan), with respect to x, dt, B, C, A, D and h0."""
    def loss(*args):
        y, h = _ssm_scan(*args)
        return jnp.sum(y * a["dy"]) + jnp.sum(h * a["dh"])
    return jax.grad(loss, argnums=tuple(range(7)))(*(a[n] for n in NAMES))


def _token_loop(x, dt, Bm, Cm, A, D, h0):
    """The scan as a differentiable loop over tokens (no in-place ops)."""
    h, ys = h0, []
    for t in range(x.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + dt[:, t, :, None] * Bm[:, t, None, :] * x[:, t, :, None]
        ys.append((h * Cm[:, t, None, :]).sum(-1) + D * x[:, t])
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("Bn,Sn,di,lens,shift", [
    (2, 13, 8, (13, 13), -1.0),       # h0 and dh non-zero
    (3, 17, 8, (17, 9, 1), -1.0),     # right-padded rows (dt = 0)
    (2, 11, 8, (11, 11), 3.0)])       # dt |A| up to ~50: a_t near 0
def test_plain_scan_backward_matches_jax_grad_and_autograd(Bn, Sn, di, lens,
                                                           shift):
    a = _scan_inputs(Bn, Sn, di, lens, shift, seed=Sn)
    want = [np.asarray(g) for g in _jax_grads(a)]
    t = {n: torch.from_numpy(x) for n, x in a.items()}
    got = ref.selective_scan_bwd(*(t[n] for n in NAMES), t["dy"], t["dh"],
                                 chunk=5)
    leaves = [t[n].clone().requires_grad_() for n in NAMES]
    y, h = _token_loop(*leaves)
    auto = torch.autograd.grad((y * t["dy"]).sum() + (h * t["dh"]).sum(),
                               leaves)
    via_fn = torch.autograd.grad([*ops.SelectiveScanFn.apply(*leaves)],
                                 leaves, [t["dy"], t["dh"]])
    for name, g, w, n, f in zip(NAMES, got, want, auto, via_fn):
        bar = 1e-5 * np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= bar, name
        assert np.abs(g.numpy() - n.numpy()).max() <= bar, name
        assert (f - g).abs().max().item() <= bar, name
    if shift > 0:      # most decays exp(dt A) far below 1
        assert np.median(a["dt"][..., None] * -a["A"]) > 10
