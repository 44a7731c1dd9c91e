"""RWKV6 training (rwkv6-1.6b's smoke: 2 layers, d 256, 4 heads of 64) in
the port against the reference's, on the CPU in float32: one train step's
loss and every gradient leaf against ``jax.value_and_grad`` of the
reference's ``forward_train`` on the same weights (through ``bridge.py``,
its float32 leaves included) and batch, three AdamW steps, remat on and
off, the eval step, and that every time-mix of a step runs its recurrence
through ``ops.Wkv6Fn`` (the serve's ``ops.wkv6`` never); and the plain
backward of the WKV recurrence, ``ref.wkv6_bwd``, against ``jax.grad`` of
a ``lax.scan`` of the reference's ``_wkv_step`` and against torch autograd
of ``ref.wkv6``, from a non-zero state with a non-zero final state's
gradient, over right-padded rows (k = 0, w = 1) and at small decays (log
w near -20).

Tolerances are tests/test_torch_train_mla.py's (float32 on both sides):
the loss within 1e-5 relative, every leaf's gradient within 1e-4 of its
max |grad|, grad_norm and lr within 1e-6 relative, three steps' losses
within 1e-4 relative; the plain backward within 1e-5 of each gradient's
max |grad| (the same products summed in another order).  The chunked
backward, the kernel's algebra, is held against ``ref.wkv6_bwd`` in
tests/test_torch_scan_chunks.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models.rwkv6 import _wkv_step
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops, ref
from repro_torch.training import trainer as TT
from test_torch_train_mla import (check_one_step, check_remat, check_steps,
                                  one_thread, port_setup, reference_steps)

ARCH = "rwkv6-1.6b"
B, S, STEPS = 2, 20, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)

assert one_thread   # the port on one PyTorch thread here too (autouse)


@pytest.fixture(scope="module")
def batch_np():
    cfg = jax_smoke(ARCH)
    return JTokenStream(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=3)).batch()


@pytest.fixture(scope="module")
def reference(batch_np):
    return reference_steps(ARCH, batch_np, STEPS, OPT)


def test_one_train_step_matches_reference(reference, batch_np):
    """Every leaf: the projections, the decay's LoRA (through log w), the
    bonus u, the group norm and both layer norms."""
    check_one_step(ARCH, reference, batch_np, OPT)


def test_three_steps_match_reference(reference, batch_np):
    check_steps(ARCH, reference, batch_np, OPT)


def test_remat_on_and_off_give_the_same_loss_and_gradients(reference,
                                                           batch_np):
    check_remat(ARCH, reference, batch_np)


def test_eval_step_is_the_forward_loss(reference, batch_np):
    cfg, params, batch = port_setup(ARCH, reference, batch_np)
    loss = TT.make_eval_step(cfg)(params, batch)
    assert not loss.requires_grad
    assert abs(loss.item() - reference["loss0"]) <= \
        1e-5 * abs(reference["loss0"])


def test_every_time_mix_reaches_the_training_recurrence(monkeypatch,
                                                        reference,
                                                        batch_np):
    """One Wkv6Fn call a layer on a step without remat, each over the
    whole window from a zero state, and none of the serve's wkv6."""
    seen, served = [], []
    apply, serve = ops.Wkv6Fn.apply, ops.wkv6

    def spy(r, k, v, logw, u, S0):
        seen.append((tuple(r.shape), bool(S0.abs().max() == 0)))
        return apply(r, k, v, logw, u, S0)

    def spy_serve(*args):
        served.append(1)
        return serve(*args)
    monkeypatch.setattr(ops.Wkv6Fn, "apply", spy)
    monkeypatch.setattr(ops, "wkv6", spy_serve)
    cfg, params, batch = port_setup(ARCH, reference, batch_np)
    TT.loss_and_grads(params, cfg, batch, remat=False)
    H = cfg.d_model // cfg.rwkv_head_dim
    assert seen == [((B, S, H, cfg.rwkv_head_dim), True)] * cfg.num_layers
    assert not served


def test_eval_step_keeps_the_float32_leaves_float32():
    """The eval step's cast to bfloat16 (the card's) keeps the leaves the
    serve keeps float32: RWKV6's decay base, bonus, group norm and the
    layer norms under ln1 / ln2."""
    cfg = torch_smoke(ARCH)
    from repro_torch.models import model as TM
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, device="cpu")
    layer = TT._CastLayers(params["layers"], torch.bfloat16)[0]
    f32 = {"decay_w0", "bonus_u", "ln_x_w", "ln_x_b"}
    for name, t in layer["rwkv"].items():
        assert t.dtype == (torch.float32 if name in f32
                           else torch.bfloat16), name
    for norm in ("ln1", "ln2"):
        assert all(t.dtype == torch.float32 for t in layer[norm].values())
    assert TT._cast(params["embed"], torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The plain backward of the WKV recurrence
# ---------------------------------------------------------------------------

def _inputs(Bn, Sn, H, hd, lens, logw_shift, seed):
    """numpy operands: r, k, v ~ N(0, 1), log w = -exp(N(shift, 1)), u =
    0.1 N(0, 1), S0 ~ N(0, 1), dy and dS ~ N(0, 1); past each row's
    length k = 0 and log w = 0 (w = 1), as the time-mix masks padding."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    mask = (np.arange(Sn)[None, :] < np.asarray(lens)[:, None])[..., None,
                                                                None]
    r, k, v = (randn(Bn, Sn, H, hd) for _ in range(3))
    k = k * mask
    logw = np.where(mask, -np.exp(randn(Bn, Sn, H, hd) + logw_shift),
                    0.0).astype(np.float32)
    return dict(r=r, k=k, v=v, logw=logw, u=0.1 * randn(H, hd),
                S0=randn(Bn, H, hd, hd), dy=randn(Bn, Sn, H, hd),
                dS=randn(Bn, H, hd, hd))


def _jax_grads(a):
    """jax.grad of sum(y dy) + sum(S_final dS) through a lax.scan of the
    reference's _wkv_step, with respect to r, k, v, log w, u and S0."""
    H, hd = a["u"].shape

    def loss(r, k, v, logw, u, S0):
        def step(Sc, inp):
            return _wkv_step(Sc, *inp, u, H, hd)
        xs = tuple(jnp.swapaxes(t, 0, 1) for t in (r, k, v, jnp.exp(logw)))
        S_fin, ys = jax.lax.scan(step, S0, xs)
        return (jnp.sum(jnp.swapaxes(ys, 0, 1) * a["dy"])
                + jnp.sum(S_fin * a["dS"]))
    names = ("r", "k", "v", "logw", "u", "S0")
    return jax.grad(loss, argnums=tuple(range(6)))(*(a[n] for n in names))


@pytest.mark.parametrize("Bn,Sn,H,hd,lens,shift", [
    (2, 13, 2, 16, (13, 13), -2.0),      # S0 and dS non-zero
    (3, 17, 2, 8, (17, 9, 1), -2.0),     # right-padded rows
    (2, 11, 3, 8, (11, 11), 3.0)])       # log w ~ -20: decays near 0
def test_plain_wkv6_backward_matches_jax_grad_and_autograd(Bn, Sn, H, hd,
                                                           lens, shift):
    a = _inputs(Bn, Sn, H, hd, lens, shift, seed=Sn)
    want = [np.asarray(g) for g in _jax_grads(a)]
    t = {n: torch.from_numpy(x) for n, x in a.items()}
    got = ref.wkv6_bwd(t["r"], t["k"], t["v"], torch.exp(t["logw"]), t["u"],
                       t["S0"], t["dy"], t["dS"])
    leaves = [t[n].clone().requires_grad_()
              for n in ("r", "k", "v", "logw", "u", "S0")]
    y, S_fin = ref.wkv6(*leaves[:3], torch.exp(leaves[3]), *leaves[4:])
    auto = torch.autograd.grad((y * t["dy"]).sum() + (S_fin * t["dS"]).sum(),
                               leaves)
    via_fn = torch.autograd.grad(
        [*ops.Wkv6Fn.apply(*leaves)], leaves, [t["dy"], t["dS"]])
    for g, w, n, f in zip(got, want, auto, via_fn):
        bar = 1e-5 * np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= bar
        assert np.abs(g.numpy() - n.numpy()).max() <= bar
        assert torch.equal(f, g)
    if shift > 0:      # most decays near exp(-20)
        assert np.median(a["logw"]) < -15
