"""RWKV6 in the port (``models/rwkv6.py``, the plain ``wkv6``, the
model's recurrent stage functions, whole-model logits) against the
reference's, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX function and
the port's; the weights are the reference's float32 ``init_params`` /
``init_rwkv_params`` handed over through ``bridge.py``, at a narrow width
for the layer tests (d_model 128: 2 heads of 64, d_ff 128) and the smoke
(2 layers, d_model 256, 4 heads) for the logits.  ``decay_w0`` is drawn
per channel around -1 (the reference's constant -2 gives every channel
the same decay) and ``bonus_u`` at scale 1, so the decay and the bonus
both move the output.  Everything is float32, so the tolerances are
float32's, for sums and products in another order: 1e-5 absolute and
relative on the recurrence's y and on every state; 1e-4 absolute on a
mixer's or a layer's output (through projections of width 128-256, of
values O(1)); 1e-4 on the logits, as ``test_torch_model.py``.

- the configs against the reference's;
- ``ref.wkv6`` (the kernel's plain version) against the reference's
  scan of ``_wkv_step``, from a zero state and from a carried one;
- ``rwkv_time_mix`` and ``rwkv_channel_mix`` unmasked and under a token
  mask: the returned state equals an unpadded run's;
- the step functions against the reference's and against one forward
  over the same tokens;
- ``prefill_recurrent_layer_batched`` and ``decode_recurrent_layer``
  with a step mask (parked rows' hidden and state unchanged, exactly);
- ``bridge.py`` keeping RWKV6's float32 leaves in a bfloat16 model;
- prefill and decode logits of the smoke;
- ``ops.wkv6`` raising for tensors off the CPU without a launch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_cfg
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.models import rwkv6 as JRW
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_cfg
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TRW
from test_torch_jamba_paths import one_thread  # noqa: F401

ATOL = RTOL = 1e-5
OUT_ATOL = LOGIT_ATOL = 1e-4
ARCH = "rwkv6-1.6b"
STATE_KEYS = ("shift_t", "shift_c", "S")


def _cfgs(**kw):
    kw = kw or dict(d_model=128, d_ff=128)
    return (dataclasses.replace(jax_smoke(ARCH), **kw),
            dataclasses.replace(torch_smoke(ARCH), **kw))


def _spread(jp, seed):
    """Per-channel decay bases around -1 and a bonus at scale 1 in RWKV
    weights (numpy; one layer's or stacked layers')."""
    r = np.random.default_rng(seed)
    jp["decay_w0"] = (-1.0 + 0.5 * r.standard_normal(
        jp["decay_w0"].shape)).astype(np.float32)
    jp["bonus_u"] = r.standard_normal(jp["bonus_u"].shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def rwkv():
    """(jax cfg, torch cfg, reference RWKV weights as numpy, the port's)."""
    jc, tc = _cfgs()
    jp = jax.tree.map(np.asarray, JRW.init_rwkv_params(
        jc, jax.random.PRNGKey(1), jnp.float32))
    _spread(jp, 11)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=RTOL)


def _states(jst, tst, atol=ATOL):
    for key in STATE_KEYS:
        _close(tst[key], jst[key], atol)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _rand_state(cfg, B, seed):
    H, hd = JRW._dims(cfg)
    r = np.random.default_rng(seed)
    return {"shift_t": r.standard_normal((B, cfg.d_model)).astype(
                np.float32),
            "shift_c": r.standard_normal((B, cfg.d_model)).astype(
                np.float32),
            "S": r.standard_normal((B, H, hd, hd)).astype(np.float32)}


def _both(st):
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v.copy()) for k, v in st.items()})


def test_config_is_the_reference_config():
    for get_t, get_j in ((torch_cfg, jax_cfg), (torch_smoke, jax_smoke)):
        tc, jc = get_t(ARCH), get_j(ARCH)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        TM.check_supported(tc)
        assert [TM.layer_kind(tc, i) for i in range(tc.num_layers)] == \
            [JM.layer_kind(jc, i) for i in range(jc.num_layers)] == \
            ["rwkv"] * tc.num_layers
    full = torch_cfg(ARCH)
    assert (full.num_layers, full.d_model, full.d_model // 64, full.d_ff,
            full.vocab_size, full.num_attention_layers(),
            full.dsa.enabled) == (24, 2048, 32, 7168, 65536, 0, False)


def _jax_wkv(r, k, v, w, u, S0):
    """The reference's recurrence as ``rwkv_time_mix`` runs it: a scan of
    ``_wkv_step`` over tokens."""
    H, hd = u.shape

    def step(S, inp):
        return JRW._wkv_step(S, *inp, u, H, hd)
    xs = tuple(jnp.swapaxes(a, 0, 1) for a in (r, k, v, w))
    S, ys = jax.lax.scan(step, S0, xs)
    return jnp.swapaxes(ys, 0, 1), S


@pytest.mark.parametrize("carried", [False, True])
def test_plain_wkv6_matches_the_reference_scan(carried):
    r = np.random.default_rng(0)
    B, S, H, hd = 2, 23, 3, 64
    rr, kk, vv = (r.standard_normal((B, S, H, hd)).astype(np.float32)
                  for _ in range(3))
    w = np.exp(-np.exp(r.standard_normal((B, S, H, hd)) - 1)).astype(
        np.float32)
    u = r.standard_normal((H, hd)).astype(np.float32)
    S0 = (r.standard_normal((B, H, hd, hd)) if carried
          else np.zeros((B, H, hd, hd))).astype(np.float32)
    args = (rr, kk, vv, w, u, S0)
    jy, jS = _jax_wkv(*map(jnp.asarray, args))
    ty, tS = ref.wkv6(*map(torch.from_numpy, args))
    assert ty.dtype == tS.dtype == torch.float32
    assert tuple(ty.shape) == (B, S, H, hd)
    _close(ty, jy)
    _close(tS, jS)


@pytest.mark.parametrize("masked", [False, True])
def test_time_mix_and_channel_mix_match(rwkv, masked):
    """Both mixers from a carried state against the reference's; under a
    token mask (right padding) the returned state equals each row's
    unpadded run's."""
    jc, tc, jp, tp = rwkv
    lens = (17, 2, 9)
    x = _x(jc, (3, 17), 3)
    mask = np.arange(17)[None, :] < np.asarray(lens)[:, None]
    jm, tm = ((jnp.asarray(mask), torch.from_numpy(mask)) if masked
              else (None, None))
    jst, tst = _both(_rand_state(jc, 3, 4))
    jo, jnew = JRW.rwkv_time_mix(jp, jc, jnp.asarray(x), jst, token_mask=jm)
    to, tnew = TRW.rwkv_time_mix(tp, tc, torch.from_numpy(x), tst,
                                 token_mask=tm)
    jc_o, jnew = JRW.rwkv_channel_mix(jp, jnp.asarray(x), jnew,
                                      token_mask=jm)
    tc_o, tnew = TRW.rwkv_channel_mix(tp, torch.from_numpy(x), tnew,
                                      token_mask=tm)
    _states(jnew, tnew)
    for b, n in enumerate(lens if masked else (17,) * 3):
        _close(to[b, :n], jo[b, :n], OUT_ATOL)
        _close(tc_o[b, :n], jc_o[b, :n], OUT_ATOL)
    if not masked:
        return
    for b, n in enumerate(lens):
        row = {k: v[b:b + 1] for k, v in tst.items()}
        xb = torch.from_numpy(x[b:b + 1, :n])
        _, own = TRW.rwkv_time_mix(tp, tc, xb, row)
        _, own = TRW.rwkv_channel_mix(tp, xb, own)
        for key in STATE_KEYS:
            torch.testing.assert_close(tnew[key][b:b + 1], own[key],
                                       atol=ATOL, rtol=RTOL)


def test_step_functions_match_the_reference_and_a_forward(rwkv):
    """The time-mix and channel-mix steps against the reference's; N
    steps from a carried state against one forward over the same N
    tokens."""
    jc, tc, jp, tp = rwkv
    x = _x(jc, (2, 6), 5)
    st = _rand_state(jc, 2, 6)
    jst, tst = _both(st)
    _, t_fwd = _both(st)
    outs = []
    for t in range(6):
        jo, jst = JRW.rwkv_time_mix_step(jp, jc, jnp.asarray(x[:, t]), jst)
        to, tst = TRW.rwkv_time_mix_step(tp, tc, torch.from_numpy(x[:, t]),
                                         tst)
        jo2, jst = JRW.rwkv_channel_mix_step(jp, jnp.asarray(x[:, t]), jst)
        to2, tst = TRW.rwkv_channel_mix_step(tp, torch.from_numpy(x[:, t]),
                                             tst)
        _close(to, jo, OUT_ATOL)
        _close(to2, jo2, OUT_ATOL)
        _states(jst, tst)
        outs.append(to)
    xt = torch.from_numpy(x)
    fo, fst = TRW.rwkv_time_mix(tp, tc, xt, t_fwd)
    _, fst = TRW.rwkv_channel_mix(tp, xt, fst)
    torch.testing.assert_close(torch.stack(outs, dim=1), fo, atol=OUT_ATOL,
                               rtol=RTOL)
    for key in STATE_KEYS:
        torch.testing.assert_close(tst[key], fst[key], atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def layer_pair():
    """An RWKV6 layer as the reference's ``init_params`` makes it (its
    RWKV weights spread as in ``rwkv``), and the port's copy."""
    jc, tc = _cfgs(num_layers=1, d_model=128, d_ff=128)
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(2), jnp.float32, stacked=False))
    _spread(jp["layers"][0]["rwkv"], 12)
    tp = params_from_numpy(jp, jc.num_layers, device="cpu")
    return jc, tc, jax.tree.map(jnp.asarray, jp["layers"][0]), \
        tp["layers"][0]


def test_recurrent_layer_functions_with_step_mask(layer_pair):
    """``prefill_recurrent_layer_batched`` over right-padded rows and
    ``decode_recurrent_layer``, each with a parked row: the reference's
    hidden and state, and the parked row's exactly as they came in."""
    jc, tc, jl, tl = layer_pair
    r = np.random.default_rng(7)
    h = r.standard_normal((3, 12, jc.d_model)).astype(np.float32)
    tmask = np.arange(12)[None, :] < np.asarray([12, 5, 12])[:, None]
    smask = np.asarray([True, True, False])
    tmask &= smask[:, None]
    jst, tst = _both(_rand_state(jc, 3, 8))
    jh, jnew = JM.prefill_recurrent_layer_batched(
        jl, jc, "rwkv", jnp.asarray(h), jnp.asarray(tmask),
        jnp.asarray(smask), jst)
    th, tnew = TM.prefill_recurrent_layer_batched(
        tl, tc, "rwkv", torch.from_numpy(h), torch.from_numpy(tmask),
        torch.from_numpy(smask), tst)
    _close(th, jh, OUT_ATOL)
    _states(jnew, tnew)
    assert torch.equal(th[2], torch.from_numpy(h[2]))
    x = h[:, 0]
    jx, jdec = JM.decode_recurrent_layer(jl, jc, "rwkv", jnp.asarray(x),
                                         jst, jnp.asarray(smask))
    tx, tdec = TM.decode_recurrent_layer(tl, tc, "rwkv",
                                         torch.from_numpy(x), tst,
                                         torch.from_numpy(smask))
    _close(tx, jx, OUT_ATOL)
    _states(jdec, tdec)
    for key in STATE_KEYS:
        assert torch.equal(tnew[key][2], tst[key][2])
        assert torch.equal(tdec[key][2], tst[key][2])


def test_bridge_keeps_the_float32_leaves(layer_pair):
    """In a bfloat16 model the layer norms ``ln1`` and ``ln2``,
    ``decay_w0``, ``bonus_u``, ``ln_x_w`` and ``ln_x_b`` stay float32, as
    the reference inits them; every other RWKV weight, the embedding, the
    final norm and the head are bfloat16."""
    jc, _, _, _ = layer_pair
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(2), jnp.bfloat16))
    tp = params_from_numpy(jp, jc.num_layers, dtype=torch.bfloat16,
                           device="cpu")
    f32 = ("decay_w0", "bonus_u", "ln_x_w", "ln_x_b")
    layer = tp["layers"][0]
    for key, v in layer["rwkv"].items():
        want = torch.float32 if key in f32 else torch.bfloat16
        assert v.dtype == want, key
        assert str(jp["layers"]["rwkv"][key].dtype) == str(want)[6:]
    for ln in ("ln1", "ln2"):
        assert {k: v.dtype for k, v in layer[ln].items()} == \
            {"w": torch.float32, "b": torch.float32}
    assert set(layer) == {"ln1", "ln2", "rwkv"}
    for key in ("embed", "final_norm", "lm_head"):
        assert tp[key].dtype == torch.bfloat16


_jax_decode_step = jax.jit(
    lambda p, c, t, s: JM.decode_step(p, c, t, s), static_argnums=1)


def test_prefill_and_decode_logits_match():
    """The smoke (2 layers, 4 heads of 64) in float32: prefill logits, then
    3 greedy decode steps, against the reference's stacked scan paths."""
    jc, tc = jax_smoke(ARCH), torch_smoke(ARCH)
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(0), jnp.float32))
    _spread(jp["layers"]["rwkv"], 20)          # stacked: every layer
    tp = params_from_numpy(jp, jc.num_layers, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.default_rng(3).integers(
        4, jc.vocab_size, (2, 45)).astype(np.int32)
    jl, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, 2)
    tl, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jst = _jax_decode_step(jp, jc, jnp.asarray(nxt), jst)
        tl, tst = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    assert [sorted(c) for c in tst["caches"]] == \
        [sorted(STATE_KEYS)] * tc.num_layers


@pytest.mark.parametrize("moved", ["r", "all"])
def test_wkv6_takes_plain_version_only_when_all_on_cpu(moved):
    """With every tensor on the CPU ``ops.wkv6`` returns its plain
    version; with one of them, or all, elsewhere (the ``meta`` device,
    standing in for the card) it raises ValueError and counts no
    launch."""
    g = torch.Generator().manual_seed(0)
    B, S, H, hd = 2, 3, 2, 64
    args = [torch.randn((B, S, H, hd), generator=g) for _ in range(4)]
    args += [torch.randn((H, hd), generator=g),
             torch.zeros((B, H, hd, hd))]
    ops.launches.reset()
    y, S_out = ops.wkv6(*args)
    assert y.device.type == S_out.device.type == "cpu"
    assert tuple(y.shape) == (B, S, H, hd)
    moved_args = [a.to("meta") if moved == "all" or i == 0 else a
                  for i, a in enumerate(args)]
    with pytest.raises(ValueError):
        ops.wkv6(*moved_args)
    assert ops.launches.counts["wkv6"] == 0
