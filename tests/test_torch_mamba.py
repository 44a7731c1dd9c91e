"""The Mamba layer of the port (``models/mamba.py``, the plain
``selective_scan``, the model's recurrent stage functions) against the
reference's, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX function and
the port's; the weights are the reference's float32 ``init_mamba_params``
(``dt_bias`` raised to -1 so that dt is O(0.3) and the state moves), a
narrow width (d_model 64: d_inner 128, dt_rank 4, d_state 16, d_conv 4).
Everything is float32, so the tolerances are float32's, for sums and
products in another order: 1e-5 absolute and relative on the scan's y
and on every state; 1e-4 absolute on a mixer's output (through in_proj
and out_proj of width 64-128); 1e-3 on a layer with its MoE, whose
experts at the reference's std 1 / sqrt(E) put outputs in the hundreds.

- ``ref.selective_scan`` (the kernel's plain version) against
  ``_ssm_scan`` with a non-zero h0, and a padded position (dt = 0)
  leaving h unchanged;
- ``mamba_forward`` from a zero state and from a carried one, and under a
  token mask: the returned state equals an unpadded run's;
- ``mamba_decode_step``, and N decode steps against one forward over the
  same N tokens;
- ``prefill_recurrent_layer_batched`` and ``decode_recurrent_layer`` with
  a step mask against the reference's (parked rows' hidden and state
  unchanged, exactly);
- ``bridge.py`` keeping ``dt_bias``, ``A_log`` and ``D`` float32 in a
  bfloat16 model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import mamba as JMB
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ref
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from test_torch_jamba_paths import one_thread  # noqa: F401

ATOL = RTOL = 1e-5
ARCH = "jamba-v0.1-52b"


def _cfgs():
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128)
    return (dataclasses.replace(jax_smoke(ARCH), **kw),
            dataclasses.replace(torch_smoke(ARCH), **kw))


@pytest.fixture(scope="module")
def mamba():
    """(jax cfg, torch cfg, reference params as numpy, the port's)."""
    jc, tc = _cfgs()
    jp = jax.tree.map(np.asarray, JMB.init_mamba_params(
        jc, jax.random.PRNGKey(1), jnp.float32))
    jp["dt_bias"] = np.full_like(jp["dt_bias"], -1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jc, tc, jp, tp


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=RTOL)


def _states(jst, tst, atol=ATOL):
    for key in ("conv", "ssm"):
        _close(tst[key], jst[key], atol)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _rand_state(cfg, B, seed):
    di, _, ds, dc = JMB._dims(cfg)
    r = np.random.default_rng(seed)
    return {"conv": r.standard_normal((B, dc - 1, di)).astype(np.float32),
            "ssm": r.standard_normal((B, di, ds)).astype(np.float32)}


def _both(st):
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v.copy()) for k, v in st.items()})


def test_plain_scan_matches_ssm_scan():
    """The kernel's plain version against ``_ssm_scan`` from a non-zero
    h0; a position with dt = 0 leaves h as it was."""
    r = np.random.default_rng(0)
    B, S, di, ds = 3, 21, 24, 16
    x = r.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, di)) - 1)).astype(
        np.float32)
    dt[1, 15:] = 0                                 # right padding
    Bm, Cm = (r.standard_normal((B, S, ds)).astype(np.float32)
              for _ in range(2))
    A = -np.exp(r.standard_normal((di, ds)).astype(np.float32))
    D, h0 = (r.standard_normal(s).astype(np.float32)
             for s in ((di,), (B, di, ds)))
    args = (x, dt, Bm, Cm, A, D, h0)
    jy, jh = JMB._ssm_scan(*map(jnp.asarray, args))
    ty, th = ref.selective_scan(*map(torch.from_numpy, args))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)
    # padding carries the state: row 1's final state is its state after
    # token 14
    _, th14 = ref.selective_scan(*(torch.from_numpy(a[:, :15]) if a.ndim == 3
                                   and a.shape[1] == S else
                                   torch.from_numpy(a) for a in args))
    torch.testing.assert_close(th[1], th14[1], rtol=0, atol=0)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba_forward_matches(mamba, carried):
    jc, tc, jp, tp = mamba
    x = _x(jc, 2, 19, 1)
    st = _rand_state(jc, 2, 2) if carried else None
    jst, tst = _both(st) if carried else (None, None)
    jo, jnew = JMB.mamba_forward(jp, jc, jnp.asarray(x), jst,
                                 return_state=True)
    to, tnew = TMB.mamba_forward(tp, tc, torch.from_numpy(x), tst,
                                 return_state=True)
    _close(to, jo, 1e-4)
    _states(jnew, tnew)
    if not carried:
        _close(TMB.mamba_forward(tp, tc, torch.from_numpy(x)), jo, 1e-4)


def test_masked_forward_state_is_the_unpadded_runs(mamba):
    """Right padding under a token mask: the returned state (conv window
    from each row's last valid inputs, scan carried through the padding)
    equals an unpadded run's, for rows shorter than the conv window too;
    and equals the reference's masked run."""
    jc, tc, jp, tp = mamba
    lens = (17, 2, 9)
    x = _x(jc, 3, 17, 3)
    mask = np.arange(17)[None, :] < np.asarray(lens)[:, None]
    jst, tst = _both(_rand_state(jc, 3, 4))
    jo, jnew = JMB.mamba_forward(jp, jc, jnp.asarray(x), jst,
                                 return_state=True,
                                 token_mask=jnp.asarray(mask))
    to, tnew = TMB.mamba_forward(tp, tc, torch.from_numpy(x), tst,
                                 return_state=True,
                                 token_mask=torch.from_numpy(mask))
    _states(jnew, tnew)
    for b, n in enumerate(lens):
        row = {k: v[b:b + 1] for k, v in tst.items()}
        _, own = TMB.mamba_forward(tp, tc, torch.from_numpy(x[b:b + 1, :n]),
                                   row, return_state=True)
        for key in ("conv", "ssm"):
            torch.testing.assert_close(tnew[key][b:b + 1], own[key],
                                       atol=ATOL, rtol=RTOL)
        _close(to[b, :n], jo[b, :n], 1e-4)


def test_decode_steps_match_the_reference_and_a_forward(mamba):
    """``mamba_decode_step`` against the reference's step; and N steps
    from a carried state against one forward over the same N tokens."""
    jc, tc, jp, tp = mamba
    x = _x(jc, 2, 6, 5)
    st = _rand_state(jc, 2, 6)
    jst, tst = _both(st)
    _, t_fwd = _both(st)
    outs = []
    for t in range(6):
        jo, jst = JMB.mamba_decode_step(jp, jc, jnp.asarray(x[:, t]), jst)
        to, tst = TMB.mamba_decode_step(tp, tc, torch.from_numpy(x[:, t]),
                                        tst)
        _close(to, jo, 1e-4)
        _states(jst, tst)
        outs.append(to)
    fo, fst = TMB.mamba_forward(tp, tc, torch.from_numpy(x), t_fwd,
                                return_state=True)
    torch.testing.assert_close(torch.stack(outs, dim=1), fo, atol=1e-4,
                               rtol=RTOL)
    for key in ("conv", "ssm"):
        torch.testing.assert_close(tst[key], fst[key], atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def layer_pair():
    """A hybrid's Mamba layer with its MoE (layer 1 of the full config's
    interleave) as the reference inits it, and the port's copy."""
    jc, tc = _cfgs()
    kw = dict(num_layers=2, moe_layer_period=2, attn_layer_period=8,
              attn_layer_offset=4)
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(2), jnp.float32))
    tp = params_from_numpy(jp, jc.num_layers, device="cpu")
    assert [TM.layer_kind(tc, i) for i in range(2)] == ["mamba"] * 2
    assert "moe" in tp["layers"][1] and "mamba" in tp["layers"][1]
    return jc, tc, JM.get_layer(jax.tree.map(jnp.asarray, jp), 1), \
        tp["layers"][1]


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
    st = _rand_state(jc, 3, 8)
    jst, tst = _both(st)
    jh, jnew = JM.prefill_recurrent_layer_batched(
        jl, jc, "mamba", jnp.asarray(h), jnp.asarray(tmask),
        jnp.asarray(smask), jst)
    th, tnew = TM.prefill_recurrent_layer_batched(
        tl, tc, "mamba", torch.from_numpy(h), torch.from_numpy(tmask),
        torch.from_numpy(smask), tst)
    _close(th, jh, 1e-3)
    _states(jnew, tnew)
    assert torch.equal(th[2], torch.from_numpy(h[2]))
    for key in ("conv", "ssm"):
        assert torch.equal(tnew[key][2], tst[key][2])
    x = h[:, 0]
    jx, jdec = JM.decode_recurrent_layer(jl, jc, "mamba", jnp.asarray(x),
                                         jst, jnp.asarray(smask))
    tx, tdec = TM.decode_recurrent_layer(tl, tc, "mamba",
                                         torch.from_numpy(x), tst,
                                         torch.from_numpy(smask))
    _close(tx, jx, 1e-3)
    _states(jdec, tdec)
    for key in ("conv", "ssm"):
        assert torch.equal(tdec[key][2], tst[key][2])


def test_bridge_keeps_the_float32_leaves(layer_pair):
    """In a bfloat16 model ``dt_bias``, ``A_log`` and ``D`` stay float32,
    as the reference inits them, beside the float32 router; every other
    Mamba weight is bfloat16."""
    jc, _, _, _ = layer_pair
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(2), jnp.bfloat16))
    tp = params_from_numpy(jp, jc.num_layers, dtype=torch.bfloat16,
                           device="cpu")
    m = tp["layers"][1]["mamba"]
    for key, v in m.items():
        want = (torch.float32 if key in ("dt_bias", "A_log", "D")
                else torch.bfloat16)
        assert v.dtype == want, key
        assert str(jp["layers"][1]["mamba"][key].dtype) == str(want)[6:]
    assert tp["layers"][1]["moe"]["router"].dtype == torch.float32
