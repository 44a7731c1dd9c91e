"""The port's mesh bodies over ``torch.distributed`` (gloo on the CPU)
against the reference package, on smoke configs with the reference's
float32 weights through ``bridge.py``:

* the expert-parallel MoE (``ffn.moe_apply_ep``) at kimi-k2's and
  jamba's smokes, on the reference's inputs (x ~ N(0, 1), (4, 8, d)):
  against the port's dense ``moe_apply`` at atol 1e-4, the reference's
  own bar between its EP and dense paths
  (``test_moe_expert_parallel_matches_dense``), and against the
  reference's ``moe_apply`` within 1e-5 of its scale (max |ref|), the
  bar ``tests/test_torch_moe.py`` holds the port's dense MoE to: these
  outputs are O(300), where one float32 step is ~3e-5 and XLA's and
  PyTorch's sums part by up to ~3e-4; the routing the same on every
  rank of a model group; the aux loss the mean of the data shards' (the
  reference's ``pmean``);
* the context-parallel decode (``decode_step(plane_mesh=...)`` over
  block-sharded pools) at qwen2-0.5b's and minicpm3-4b's smokes, two
  steps, against the reference's single-device ``decode_step`` at atol
  2e-4 (its ``test_cp_decode_matches_reference`` and
  ``test_cp_mla_decode_matches_reference``), the selected block sets
  equal; also with a reduced DSA (block 8, top-4 blocks), so the
  selection drops blocks;
* the sequence-parallel prefill layer at qwen2-0.5b on a 37-token window
  over 2 and 4 ranks (neither divides it) against the reference's
  replicated layer at atol 2e-5 (its
  ``test_sharded_prefill_attn_layer_pads_nondividing_window``);
* the plain partial decode attention against the reference's
  ``dsa.sparse_decode_attention_partial``.

Ranks come from one ``torch.multiprocessing.spawn`` per world size (2:
(data 1, model 2); 4: (data 2, model 2), and (data 1, model 4) for the
prefill layer), a ``file://`` store, no network; every case runs in it
(``tests/torch_mesh_worker.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import dsa as jdsa
from repro.models import ffn as JF
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import ffn as TF
from repro_torch.models.common import DSAConfig as TDSA

import torch_mesh_worker

EP_ARCHS = ("kimi-k2-1t-a32b", "jamba-v0.1-52b")
CP_RUNS = (("qwen2-0.5b", None, 8), ("qwen2-0.5b", (8, 32), 24),
           ("minicpm3-4b", None, 8))
SP_T = 37
STEPS = ((5, 9), (3, 2))
_jax_decode = jax.jit(
    lambda p, c, t, s: JM.decode_step(p, c, t, s, return_info=True),
    static_argnums=1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, dsa=None):
    jc, tc = jax_smoke(arch), torch_smoke(arch)
    if dsa is not None:
        jc = dataclasses.replace(jc, dsa=JDSA(block_size=dsa[0],
                                              token_budget=dsa[1]))
        tc = dataclasses.replace(tc, dsa=TDSA(block_size=dsa[0],
                                              token_budget=dsa[1]))
    return jc, tc


def _ep_cases():
    cases, refs = [], []
    for arch in EP_ARCHS:
        jc, tc = _cfgs(arch)
        p = JF.init_moe_params(jc, jax.random.PRNGKey(0), jnp.float32)
        x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                       (4, 8, jc.d_model)))
        y, aux = JF.moe_apply(p, jc, jnp.asarray(x))
        # the data shards' aux losses, (data 2, model 2)'s pmean
        aux2 = np.mean([float(JF.moe_apply(p, jc, jnp.asarray(x[s]))[1])
                        for s in (slice(0, 2), slice(2, 4))])
        tp = params_from_numpy({"layers": [_np_tree(p)]}, 1)["layers"][0]
        dense = TF.moe_apply(tp, tc, torch.from_numpy(x))[0].numpy()
        cases.append(dict(kind="ep", model=2, cfg=tc, params=_np_tree(p),
                          x=x, drop_free=False))
        refs.append(dict(arch=arch, y=np.asarray(y), dense=dense,
                         aux={2: float(aux), 4: aux2}))
    return cases, refs


def _cp_cases():
    cases, refs = [], []
    for arch, dsa, nb in CP_RUNS:
        jc, tc = _cfgs(arch, dsa)
        params = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
        toks = np.random.default_rng(0).integers(
            4, jc.vocab_size, (2, 128)).astype(np.int32)
        _, st = JM.prefill(params, jc, {"tokens": jnp.asarray(toks)}, nb,
                           cache_dtype=jnp.float32)
        logits, sel = [], []
        for step in STEPS:
            lg, st, info = _jax_decode(params, jc,
                                       jnp.asarray(step, jnp.int32), st)
            logits.append(np.asarray(lg))
            sel.append({i: np.asarray(v)
                        for i, v in info["selected"].items()})
        cases.append(dict(kind="cp", model=2, cfg=tc,
                          params=_np_tree(params), tokens=toks, nb=nb,
                          steps=[np.asarray(s, np.int32) for s in STEPS]))
        refs.append(dict(arch=arch, dsa=dsa, logits=logits, selected=sel))
    return cases, refs


def _sp_case(model):
    jc, tc = _cfgs("qwen2-0.5b")
    params = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    B = 2
    h = np.array(jax.random.normal(jax.random.PRNGKey(3),
                                   (B, SP_T, jc.d_model), jnp.float32))
    pos = np.broadcast_to(np.arange(SP_T, dtype=np.int32), (B, SP_T)).copy()
    tmask = np.ones((B, SP_T), bool)
    tmask[1, 30:] = False                 # a right-padded row
    smask = np.ones((B,), bool)
    x, (k, v) = JM.prefill_attn_layer_batched(
        JM.get_layer(params, 0), jc, jnp.asarray(h), jnp.asarray(pos),
        jnp.asarray(tmask), jnp.asarray(smask))
    case = dict(kind="sp", model=model, cfg=tc, params=_np_tree(params),
                h=h, positions=pos, token_mask=tmask, step_mask=smask)
    return case, dict(x=np.asarray(x), k=np.asarray(k), v=np.asarray(v))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (refs, each rank's results)}: one spawn per world size."""
    ep, ep_refs = _ep_cases()
    cp, cp_refs = _cp_cases()
    out = {}
    for world, sp_model in ((2, 2), (4, 4)):
        sp, sp_ref = _sp_case(sp_model)
        cases = ep + cp + [sp]
        ranks = torch_mesh_worker.spawn(
            cases, world, tmp_path_factory.mktemp(f"world{world}"))
        out[world] = (dict(ep=ep_refs, cp=cp_refs, sp=sp_ref), ranks,
                      len(ep), len(cp))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("which", range(len(EP_ARCHS)))
def test_expert_parallel_moe_matches_reference(runs, world, which):
    refs, ranks, _, _ = runs[world]
    ref = refs["ep"][which]
    y = np.zeros_like(ref["y"])
    for r, res in enumerate(ranks):
        got = res[which]
        lo, hi = got["rows"]
        y[lo:hi] = got["y"]
        # ranks of one model group (consecutive) route alike
        peer = ranks[r ^ 1][which]
        np.testing.assert_array_equal(got["experts"], peer["experts"])
        np.testing.assert_array_equal(got["gates"], peer["gates"])
        np.testing.assert_allclose(got["aux"], ref["aux"][world],
                                   rtol=1e-5)
    assert ranks[0][which]["rows"] == ((0, 4) if world == 2 else (0, 2))
    np.testing.assert_allclose(y, ref["dense"], atol=1e-4)
    np.testing.assert_allclose(y, ref["y"],
                               atol=1e-5 * np.abs(ref["y"]).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("which", range(len(CP_RUNS)))
def test_context_parallel_decode_matches_reference(runs, world, which):
    refs, ranks, n_ep, _ = runs[world]
    ref = refs["cp"][which]
    for res in ranks:
        got = res[n_ep + which]
        for step, want in enumerate(ref["logits"]):
            np.testing.assert_allclose(got["logits"][step], want,
                                       atol=2e-4)
            for layer, jsel in ref["selected"][step].items():
                tsel = got["selected"][step][layer]
                for b in range(jsel.shape[0]):
                    assert set(tsel[b].ravel()) == set(jsel[b].ravel())


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_prefill_layer_pads_nondividing_window(runs,
                                                                 world):
    refs, ranks, n_ep, n_cp = runs[world]
    assert SP_T % world
    for res in ranks:
        got = res[n_ep + n_cp]
        for key in ("x", "k", "v"):
            np.testing.assert_allclose(got[key], refs["sp"][key], atol=2e-5,
                                       rtol=2e-5)


@pytest.mark.parametrize("offset,G,D,Dv", [(0, 7, 16, 16), (3, 4, 24, 24),
                                           (5, 8, 48, 48)])
def test_plain_partial_matches_reference(offset, G, D, Dv):
    """Local ids over a shard whose block 0 is global block ``offset``,
    a row whose shard holds no valid position (m = NEG_INF, l = 0)."""
    r = np.random.default_rng(offset)
    B, Hkv, NB, bs, K = 3, 2, 6, 8, 4
    q = r.standard_normal((B, Hkv * G, D), dtype=np.float32)
    kp = r.standard_normal((B, Hkv, NB, bs, D), dtype=np.float32)
    vp = (kp[..., :Dv] if Dv == D else
          r.standard_normal((B, Hkv, NB, bs, Dv), dtype=np.float32))
    idx = np.stack([r.permutation(NB)[:K] for _ in range(B * Hkv)]
                   ).reshape(B, Hkv, K).astype(np.int32)
    valid = r.random((B, Hkv, K)) > 0.3
    valid[2] = False
    cur_len = np.array([(offset + NB) * bs, (offset + 2) * bs + 3, 7],
                       np.int32)
    got = ops.sparse_decode_attention_partial(
        *(torch.from_numpy(a) for a in (q, kp, vp, idx, valid, cur_len)),
        offset, scale=0.3)
    want = jdsa.sparse_decode_attention_partial(
        *(jnp.asarray(a) for a in (q, kp, vp, idx, valid, cur_len)), offset,
        scale=0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    assert (got[1][2] == -1e30).all() and (got[2][2] == 0).all()
