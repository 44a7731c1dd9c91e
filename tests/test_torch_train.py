"""The port's training path against the reference's, on the CPU in
float32: the plain backward of ``flash_prefill`` (``FlashPrefillFn``)
against ``jax.grad`` of the reference's ``flash_attention_jnp`` and
against torch autograd of a naive attention; one train step of
``repro_torch.training.trainer`` against ``repro.training.trainer``'s
``make_train_step`` on the same weights (through ``bridge.py``) and
batch; three steps' losses; remat on and off; the launcher on the CPU;
which families the port trains (MLA, the frontends and RWKV6 are held
against the reference in tests/test_torch_train_mla.py,
tests/test_torch_train_frontends.py and tests/test_torch_train_rwkv.py).

Tolerances, float32 on both sides: the backward within 1e-5 of each
tensor's max |grad| (sums over keys in another order and chunking); the
loss within 1e-5 relative, every leaf's gradient within 1e-4 of its max
|grad| (the attention's chunked sums and the remat recompute round
apart from XLA's fused ones), ``grad_norm`` and ``lr`` within 1e-6
relative; three steps' losses within 1e-4 relative (AdamW's normalised
update turns a gradient's last-bit differences into weight differences:
the K bias's gradient is 0 up to rounding, a softmax being blind to a
shift of every score of a row, and AdamW moves it by up to lr all the
same).  The port runs on one PyTorch thread
(``one_thread``), as the Jamba modules do."""
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
from repro.training import trainer as JT
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import init_opt_state as j_init_opt
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.training import trainer as TT
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.optimizer import tree_leaves

ARCH = "qwen2-0.5b"
B, S, STEPS = 2, 48, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The backward of flash_prefill
# ---------------------------------------------------------------------------

def _naive(q, k, v, scale):
    """Causal GQA attention written out, for torch autograd."""
    G = q.shape[2] // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    n = q.shape[1]
    s = s.masked_fill(torch.triu(torch.ones(n, n, dtype=torch.bool), 1),
                      -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)


@pytest.mark.parametrize("Bn,Sn,Hq,Hkv,D", [(2, 37, 7, 1, 32),
                                            (1, 600, 8, 2, 16)])
def test_flash_prefill_backward_matches_jax_grad_and_autograd(Bn, Sn, Hq,
                                                              Hkv, D):
    """G 7 and G 4, ragged S (600 spans two of the plain version's 512-row
    chunks)."""
    rng = np.random.default_rng(Sn)
    q, k, v = (rng.standard_normal((Bn, Sn, h, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    do = rng.standard_normal((Bn, Sn, Hq, D)).astype(np.float32)
    scale = D ** -0.5

    def jloss(q_, k_, v_):
        o = flash_attention_jnp(q_, k_, v_, scale=scale, causal=True)
        return jnp.sum(o * do)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_prefill(tq, tk, tv, scale=scale)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    naive = torch.autograd.grad(_naive(tq, tk, tv, scale), (tq, tk, tv),
                                torch.from_numpy(do))
    for g, w, n in zip(got, want, naive):
        w = np.asarray(w)
        bar = 1e-5 * np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= bar
        assert np.abs(g.numpy() - n.numpy()).max() <= bar


def test_backward_limits_raise_naming_the_roadmap_item():
    x = torch.zeros((1, 8, 2, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="training step 5"):
        ops.flash_prefill(x, x, x, scale=0.25, q_offset=4)


@pytest.mark.parametrize("shape", [
    (1, 300, 7, 1, 32),      # an odd group (arctic-like), ragged
    (2, 200, 14, 2, 16),     # qwen2-0.5b's group of 7 over 2 kv heads
    (1, 257, 32, 8, 16),     # llama3-8b's G 4
    (1, 130, 4, 2, 32),      # G 2, one row past a 128-key tile
    (2, 64, 4, 4, 16),       # G 1: one chunk, no sum
    (1, 100, 6, 3, 32)])     # G 2 over 3 kv heads, one ragged tile
def test_backward_chunks_sum_to_the_gradient(shape):
    """The split that the dK-dV kernel runs, in plain PyTorch: each query
    head's share (its chunk) of dK and dV -- the plain backward with the
    group's other heads' dO zeroed, which zeroes their P^T dO and dS^T Q
    -- summed in head order gives the whole group's within float32
    rounding, and with the last head's share left out fails the card's bar
    (2e-2 of max |grad|)."""
    Bn, Sn, Hq, Hkv, D = shape
    G = Hq // Hkv
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (Bn, Sn, h, D)).astype(np.float32)) for h in (Hq, Hkv, Hkv, Hq))
    o, lse = ops.flash_prefill_fwd_lse(q, k, v, scale=0.2)
    _, dk, dv = ops.flash_prefill_bwd(q, k, v, o, lse, do, scale=0.2)
    parts = []
    for c in range(G):
        keep = torch.zeros_like(do)
        keep[:, :, c::G] = do[:, :, c::G]    # head c of every group
        parts.append(ops.flash_prefill_bwd(q, k, v, o, lse, keep,
                                           scale=0.2)[1:])
    for i, want in enumerate((dk, dv)):
        total = parts[0][i].clone()
        for p in parts[1:]:
            total += p[i]
        bar = want.abs().max()
        assert (total - want).abs().max() <= 1e-5 * bar
        assert (total - parts[-1][i] - want).abs().max() > 2e-2 * bar


# ---------------------------------------------------------------------------
# Train steps against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """The reference's smoke weights (float32), one batch of its
    TokenStream, and the reference's train steps: the jitted
    ``make_train_step`` run STEPS times, and the first step's gradients
    from ``jax.value_and_grad`` of its ``forward_train``."""
    jcfg = jax_smoke(ARCH)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    raw = JTokenStream(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=3)).batch()
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    np_params = jax.tree.map(np.asarray, jp)
    loss0, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.forward_train(p, jcfg, jbatch, remat=True)[0]))(jp)
    step = jax.jit(JT.make_train_step(jcfg, JAdamWConfig(**OPT), True))
    params, opt, metrics = jp, j_init_opt(jp), []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, jbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    n = jcfg.num_layers
    return dict(np_params=np_params, n=n, raw=raw, loss0=float(loss0),
                grads=params_from_numpy(jax.tree.map(np.asarray, jgrads), n,
                                        dtype=torch.float32),
                metrics=metrics)


def _port(setup):
    params = TT.trainable(params_from_numpy(setup["np_params"], setup["n"],
                                            dtype=torch.float32))
    batch = TT.batch_to(setup["raw"], torch.device("cpu"))
    return torch_smoke(ARCH), params, batch


def test_one_train_step_matches_reference(setup):
    cfg, params, batch = _port(setup)
    loss, grads = TT.loss_and_grads(params, cfg, batch, remat=True)
    assert abs(loss.item() - setup["loss0"]) <= 1e-5 * abs(setup["loss0"])
    want = tree_leaves(setup["grads"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        bar = 1e-4 * w.abs().max().item()
        assert (g - w).abs().max().item() <= bar
    step = TT.make_train_step(cfg, AdamWConfig(**OPT), remat=True)
    _, _, m = step(params, init_opt_state(params), batch)
    ref = setup["metrics"][0]
    assert abs(m["loss"].item() - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for key in ("grad_norm", "lr"):
        assert abs(m[key].item() - ref[key]) <= 1e-6 * abs(ref[key]), key


def test_three_steps_match_reference(setup):
    cfg, params, batch = _port(setup)
    step = TT.make_train_step(cfg, AdamWConfig(**OPT), remat=True)
    opt = init_opt_state(params)
    for i in range(STEPS):
        params, opt, m = step(params, opt, batch)
        ref = setup["metrics"][i]["loss"]
        assert abs(m["loss"].item() - ref) <= 1e-4 * abs(ref), i
    assert int(opt["step"]) == STEPS


def test_remat_on_and_off_give_the_same_loss_and_gradients(setup):
    cfg, params, batch = _port(setup)
    with_remat = TT.loss_and_grads(params, cfg, batch, remat=True)
    without = TT.loss_and_grads(params, cfg, batch, remat=False)
    assert with_remat[0].item() == without[0].item()
    for a, b in zip(with_remat[1], without[1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_eval_step_is_the_forward_loss(setup):
    cfg, params, batch = _port(setup)
    loss = TT.make_eval_step(cfg)(params, batch)
    assert not loss.requires_grad
    assert abs(loss.item() - setup["loss0"]) <= 1e-5 * abs(setup["loss0"])


def test_train_loop_logs_and_checkpoints(tmp_path):
    """``train`` on the CPU: the reference's log points (step 1, then every
    ``log_every``) and a final checkpoint of params and optimizer state
    that restores into the returned params."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.training.checkpoint import restore_checkpoint
    cfg = torch_smoke(ARCH)
    ck = str(tmp_path / "ck.npz")
    params, hist = TT.train(
        cfg, TT.TrainConfig(steps=3, log_every=2, ckpt_path=ck,
                            opt=AdamWConfig(**OPT)),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2),
        device="cpu", verbose=False)
    assert len(hist["loss"]) == len(hist["grad_norm"]) == 2
    back, step = restore_checkpoint(ck, {"params": params,
                                         "opt": init_opt_state(params)})
    assert step == 3 and int(back["opt"]["step"]) == 3
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(back["params"])))


def test_launcher_trains_the_smoke_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    ck = tmp_path / "ck.npz"
    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--remat", "--ckpt", str(ck)]) == 0
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "step     2 loss" in out
    assert ck.exists()


@pytest.mark.parametrize("arch", ["minicpm3-4b", "internvl2-2b",
                                  "whisper-small", "rwkv6-1.6b"])
def test_mla_and_frontend_families_are_trainable(arch):
    """Their full configs (and RWKV6's) pass ``check_trainable`` and
    their smokes train a step in the launcher's loop, each batch with the
    launcher's frontend stand-ins (tests/test_torch_train_mla.py,
    tests/test_torch_train_frontends.py and
    tests/test_torch_train_rwkv.py hold them against the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    TM.check_trainable(get_config(arch))
    cfg = torch_smoke(arch)
    _, hist = TT.train(
        cfg, TT.TrainConfig(steps=1, log_every=1, opt=AdamWConfig(**OPT)),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2),
        device="cpu", verbose=False)
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
