"""The port's training support against the reference's, on the CPU: the
data pipeline (``TokenStream``, ``eval_stream``: the same arrays, bit for
bit, from the same seeds), AdamW alone (``adamw_update`` on identical
numpy parameters, gradients and state, within 1e-6 of each leaf's
scale; the schedules' learning rates within 1e-6 relative), and the
checkpoints (exact round trips, the reference's key paths, raises on a
shape mismatch or a missing key)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro_torch.data import pipeline as TP
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=64, global_batch=3, seed=0),
    dict(vocab_size=151936, seq_len=33, global_batch=4, num_hosts=2,
         host_id=1, seed=7, zipf_a=1.1, repeat_p=0.5, repeat_window=8)])
def test_token_stream_and_eval_stream_equal_the_reference(kw):
    js, ts = JP.TokenStream(JP.DataConfig(**kw)), TP.TokenStream(
        TP.DataConfig(**kw))
    for _ in range(3):
        a, b = js.batch(), ts.batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    je = JP.eval_stream(JP.DataConfig(**kw), 2)
    te = TP.eval_stream(TP.DataConfig(**kw), 2)
    for a, b in zip(je, te):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_host_batch_must_divide():
    with pytest.raises(ValueError):
        TP.DataConfig(vocab_size=16, seq_len=4, global_batch=3,
                      num_hosts=2).host_batch


def _tree(rng):
    """A params-like tree: a matrix and a vector (weight decay on the
    matrix only) and a list of layer dicts."""
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": f(6, 4), "norm": f(4),
            "layers": [{"w": f(4, 3), "b": f(3)}, {"w": f(4, 3), "b": f(3)}]}


@pytest.mark.parametrize("schedule,step", [("cosine", 0), ("cosine", 7),
                                           ("linear", 30), ("constant", 3)])
def test_adamw_update_equals_the_reference(schedule, step):
    rng = np.random.default_rng(step)
    p, g, m, v = (_tree(rng) for _ in range(4))
    v = jax.tree.map(np.abs, v)
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=40, schedule=schedule,
               grad_clip=0.5)
    jstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.asarray(step, jnp.int32)}
    jp, js, jm = JO.adamw_update(JO.AdamWConfig(**cfg),
                                 jax.tree.map(jnp.asarray, p),
                                 jax.tree.map(jnp.asarray, g), jstate)
    tt = lambda t: TO.tree_map(torch.from_numpy, t)  # noqa: E731
    tp = tt(jax.tree.map(np.copy, p))
    tstate = {"m": tt(jax.tree.map(np.copy, m)),
              "v": tt(jax.tree.map(np.copy, v)),
              "step": torch.tensor(step, dtype=torch.int32)}
    tm = TO.adamw_update(TO.AdamWConfig(**cfg), tp, tt(g), tstate)
    assert int(tstate["step"]) == step + 1
    for key in ("grad_norm", "lr"):
        assert abs(tm[key].item() - float(jm[key])) <= 1e-6 * abs(
            float(jm[key]))
    for got, want in ((tp, jp), (tstate["m"], js["m"]),
                      (tstate["v"], js["v"])):
        for a, b in zip(TO.tree_leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-6 * max(
                1.0, np.abs(b).max())


def test_tree_order_is_the_references():
    t = _tree(np.random.default_rng(0))
    paths = ["/".join(p) for p, _ in TO.tree_leaves_with_path(t)]
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths == want


def test_checkpoint_round_trips_and_reads_the_references(tmp_path):
    rng = np.random.default_rng(1)
    tree = TO.tree_map(torch.from_numpy, _tree(rng))
    tree["half"] = torch.randn(5, 2).to(torch.bfloat16)
    state = TO.init_opt_state(tree)
    state["step"].fill_(12)
    path = str(tmp_path / "ck.npz")
    TC.save_checkpoint(path, {"params": tree, "opt": state}, 12)
    back, step = TC.restore_checkpoint(path, {"params": tree, "opt": state})
    assert step == 12
    for (pa, a), (pb, b) in zip(
            TO.tree_leaves_with_path({"params": tree, "opt": state}),
            TO.tree_leaves_with_path(back)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)
    # the reference restores the port's file into its own tree
    jtree = jax.tree.map(jnp.asarray, {"params": TO.tree_map(
        lambda t: t.float().numpy(), tree)})
    jback, jstep = JC.restore_checkpoint(path, jtree)
    assert jstep == 12
    np.testing.assert_array_equal(np.asarray(jback["params"]["embed"]),
                                  tree["embed"].numpy())


def test_checkpoint_restore_raises_on_shape_or_key(tmp_path):
    tree = {"a": torch.zeros(3, 2), "b": [torch.ones(4)]}
    path = str(tmp_path / "ck.npz")
    TC.save_checkpoint(path, tree)
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.restore_checkpoint(path, {"a": torch.zeros(2, 3),
                                     "b": [torch.ones(4)]})
    with pytest.raises(KeyError, match="c"):
        TC.restore_checkpoint(path, {"a": torch.zeros(3, 2),
                                     "b": [torch.ones(4)],
                                     "c": torch.zeros(1)})
