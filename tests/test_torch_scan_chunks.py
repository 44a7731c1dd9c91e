"""The time-chunk decomposition of the port's two recurrences, in plain
PyTorch on the CPU, against their plain versions.

``wkv6``'s kernel cuts a window into chunks of L tokens (csrc/wkv6.cu):
(1) each chunk's recurrence from a zero state gives its end state S_loc[c]
and the product of its decays W[c]; (2) S_in[c+1] = W[c] S_in[c] +
S_loc[c] from S_in[0] = S0; (3) each chunk rerun from S_in[c] gives y.
The Mamba scan's state update h = dA h + (dt x) B is linear in h the same
way, but the scan's kernel does not chunk over time (a one-row window
already fills the card, and chunks would compute every exponential twice:
csrc/selective_scan.cu); its half here pins the algebra that a
time-chunked scan would rest on, a design not taken.  The helpers here compute those three phases with the plain versions
inside each chunk; they are held against the token walk under the bars
the kernels are held to on the card (``chip_smoke.py``): wkv6 per element
within 2^-14 of the plain version on the inputs' magnitudes plus 1e-6,
the scan within 1e-5 + 1e-4 |ref|.  Cases: a window that is a multiple of
the chunk, one that is not, right padding from the middle of a chunk
across chunk edges, a carried state, and a window of at most one chunk.
Also ``ops.wkv6_chunk``, which picks the kernel's chunk length.

The backward of ``wkv6`` (csrc/wkv6_bwd.cu, kernel B) runs the forward's
chunks in reverse: each chunk's lam (the state's gradient) walked back
from zero, a carry over chunks from the final state's gradient, and
each chunk rerun, the states forward from the forward's S_in[c] and lam
back from its carry, with the decay's gradient a suffix sum whose only
term from later chunks is <lam, S> at the chunk's end.
``wkv6_bwd_chunked`` computes those phases in plain PyTorch; it is held
against ``ref.wkv6_bwd`` under the kernel's bar on the card: each
gradient within 2^-12 of its max |grad| with a cosine >= 0.99999.

The backward of the selective scan (csrc/selective_scan_bwd.cu, kernel
D) walks the training forward's 64-token chunks in reverse, each rerun
from the state kernel C stored before it (its checkpoint): the states
forward over the chunk, each 8-token sub-chunk's start kept, then sub-
chunk by sub-chunk in reverse the states rerun and the state's gradient
g walked back, carried over chunks; the sums over channels (dB, dC) as
one partial per group of 32 channels, summed over the groups in order,
and dA, dD per row, summed over the rows.  ``scan_bwd_chunked`` computes
those phases in plain PyTorch; it is held against
``ref.selective_scan_bwd`` under kernel D's bar on the card, the same
2^-12 and 0.99999, and three planted faults (a channel group's partial
left out, the chunks rerun from a zero state instead of their
checkpoints, g's carry into the chunk before dropped) must fail it."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

WKV_RTOL, WKV_ATOL = 2.0 ** -14, 1e-6
WKV_GRAD_ERR, WKV_GRAD_COS = 2.0 ** -12, 0.99999
SCAN_ATOL, SCAN_RTOL = 1e-5, 1e-4

# (label, B, S, row lengths, L, carried state)
CASES = [("multiple", 2, 96, (96, 96), 32, False),
         ("ragged", 2, 100, (100, 100), 32, False),
         ("padded_mid_chunk", 2, 100, (100, 45), 32, True),
         ("carried", 1, 70, (70,), 16, True),
         ("one_chunk", 2, 20, (20, 13), 32, True),
         # the window ends mid-stage (kernel B stages 16 tokens): a last
         # chunk of 13, and one chunk of 45 whose suffix starts from
         # a_end = <dS, S_end> with no chunk after it
         ("ends_mid_stage", 1, 45, (45,), 32, True),
         ("one_chunk_mid_stage", 1, 45, (45,), 48, False)]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain walks' small ops on one thread, the count restored after
    (under the suite's parallel workers a thread pool per process is
    slower, not faster)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask(B, S, lens):
    return torch.arange(S)[None, :] < torch.tensor(lens)[:, None]


def _wkv_inputs(rng, B, S, H, lens, carried):
    """wkv6's inputs as the time-mix hands them over, from numpy: r, k, v
    ~ N(0, 1) rounded through bf16 (the card's dtype), w = exp(-exp(N(-2,
    1))), u = 0.1 N(0, 1), S0 ~ N(0, 1) when carried, else 0; k = 0 and
    w = 1 past each row's length."""
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    m = _mask(B, S, lens)[..., None, None]
    r, k, v = (randn(B, S, H, 16).bfloat16().float() for _ in range(3))
    k = k * m
    w = torch.where(m, torch.exp(-torch.exp(randn(B, S, H, 16) - 2)), 1.0)
    S0 = randn(B, H, 16, 16) if carried else torch.zeros(B, H, 16, 16)
    return r, k, v, w, 0.1 * randn(H, 16), S0


def _chunks(S, L):
    """The kernels' time chunks of a window of S tokens: [t0, t1) ranges
    of L tokens, one range when S <= L."""
    return [(c, min(c + L, S)) for c in range(0, S, L)] if S > L else [(0, S)]


def wkv6_carries(r, k, v, w, u, S0, L):
    """Phases 1 and 2 of the forward: S_in[c], the state before each
    chunk, as kernel A keeps them for the backward."""
    chunks = _chunks(r.shape[1], L)
    # 1. each chunk but the last from a zero state: S_loc and W
    loc, decay = [], []
    for t0, t1 in chunks[:-1]:
        sl = slice(t0, t1)
        _, s_end = ref.wkv6(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u,
                            torch.zeros_like(S0))
        loc.append(s_end)
        p = torch.ones_like(w[:, 0])
        for t in range(t0, t1):      # token by token, as the kernel
            p = p * w[:, t]
        decay.append(p)
    # 2. the carries
    s_in = [S0]
    for s_loc, p in zip(loc, decay):
        s_in.append(p[..., None] * s_in[-1] + s_loc)
    return s_in


def wkv6_chunked(r, k, v, w, u, S0, L):
    """wkv6 in the kernel's three phases over chunks of L tokens (one
    pass from S0 when S <= L)."""
    S = r.shape[1]
    if S <= L:
        return ref.wkv6(r, k, v, w, u, S0)
    # 3. each chunk from its carried state
    ys = []
    for (t0, t1), s0 in zip(_chunks(S, L),
                            wkv6_carries(r, k, v, w, u, S0, L)):
        sl = slice(t0, t1)
        y, s_fin = ref.wkv6(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, s0)
        ys.append(y)
    return torch.cat(ys, dim=1), s_fin


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def wkv6_bwd_chunked(r, k, v, w, u, S0, dy, dS, L, fault=None):
    """The gradient of wkv6 in kernel B's phases (csrc/wkv6_bwd.cu) over
    the forward's chunks of L tokens: (1) each chunk walked forward twice,
    R (S from S_in[c]: dr, and Q_t = r_t (S_t dy_t); the last chunk also
    a_end = <dS, S_end> per channel) and, for c >= 1, the local pass
    (lam_loc[c] = sum_t D_t r_t dy_t^T, D_t the chunk's decays before t,
    and the decay product W[c]); (2) lam_end[nc-1] = dS, lam_end[c-1] =
    W[c] lam_end[c] + lam_loc[c]; (3) each chunk walked back from
    lam_end[c], K (dk; the suffix a from a_end = <lam_end[c], S_in[c+1]>
    (the last chunk's from R), dlogw_t = a - P_t with P_t = k_t (lam_{t+1}
    v_t), a <- a - P_t + Q_t; chunk 0 gives dS0) and V (dv).  ``fault``
    plants one of the kernel faults the bar must reject: "u_in_dk" (u's
    term dropped from dk), "decay_carry" (a from zero in every chunk but
    the last), "a_end" (every chunk's suffix from zero: R's and K's a_end
    left out), "lam_carry" (every chunk but the last walked back from lam
    = 0)."""
    chunks = _chunks(r.shape[1], L)
    nc = len(chunks)
    s_in = wkv6_carries(r, k, v, w, u, S0, L)
    # 1. R and the local pass, forward
    q, dr = {}, torch.empty_like(r)
    lam_loc, decay = {}, {}
    for c, (t0, t1) in enumerate(chunks):
        St = s_in[c]
        lam, p = torch.zeros_like(S0), torch.ones_like(w[:, 0])
        for t in range(t0, t1):
            dyv = (dy[:, t] * v[:, t]).sum(-1, keepdim=True)
            sdy = torch.einsum("bhij,bhj->bhi", St, dy[:, t])
            dr[:, t] = sdy + u * k[:, t] * dyv
            q[t] = r[:, t] * sdy
            St = w[:, t, :, :, None] * St + _outer(k[:, t], v[:, t])
            lam = lam + _outer(p * r[:, t], dy[:, t])
            p = p * w[:, t]
        lam_loc[c], decay[c] = lam, p
    a_last = (dS * St).sum(-1)
    # 2. the carries, backward
    lam_end = [None] * nc
    lam_end[-1] = dS
    for c in range(nc - 1, 0, -1):
        lam_end[c - 1] = decay[c][..., None] * lam_end[c] + lam_loc[c]
    if fault == "lam_carry":
        lam_end = [torch.zeros_like(dS)] * (nc - 1) + [dS]
    # 3. K and V, back
    dk, dv, dlogw = (torch.empty_like(r) for _ in range(3))
    du = torch.zeros_like(u)
    for c, (t0, t1) in enumerate(chunks):
        lam = lam_end[c]
        a = (lam * s_in[c + 1]).sum(-1) if c < nc - 1 else a_last
        if (fault == "decay_carry" and c < nc - 1) or fault == "a_end":
            a = torch.zeros_like(a)
        for t in range(t1 - 1, t0 - 1, -1):
            dyv = (dy[:, t] * v[:, t]).sum(-1, keepdim=True)
            lv = torch.einsum("bhij,bhj->bhi", lam, v[:, t])
            dk[:, t] = lv + (0 if fault == "u_in_dk" else r[:, t] * u * dyv)
            dv[:, t] = (torch.einsum("bhij,bhi->bhj", lam, k[:, t])
                        + (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)
                        * dy[:, t])
            a = a - k[:, t] * lv
            dlogw[:, t] = a
            a = a + q[t]
            du += (r[:, t] * k[:, t] * dyv).sum(0)
            lam = w[:, t, :, :, None] * lam + _outer(r[:, t], dy[:, t])
        if c == 0:
            dS0 = lam
    return dr, dk, dv, dlogw, du, dS0


def _scan_inputs(rng, B, S, di, lens, carried):
    """selective_scan's inputs as a Mamba layer hands them over, from
    numpy: x, B, C ~ N(0, 1) rounded through bf16, dt = softplus(N(-2,
    1)) zeroed past each row's length, A = -exp(log(1..16) + N(0,
    0.1^2)), D = 1 + N(0, 0.1^2), h0 ~ N(0, 1) when carried, else 0."""
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = randn(B, S, di).bfloat16().float()
    dt = torch.nn.functional.softplus(randn(B, S, di) - 2) \
        * _mask(B, S, lens)[..., None]
    Bm, Cm = (randn(B, S, 16).bfloat16().float() for _ in range(2))
    A = -torch.exp(torch.arange(1, 17).float().log() + 0.1 * randn(di, 16))
    h0 = randn(B, di, 16) if carried else torch.zeros(B, di, 16)
    return x, dt, Bm, Cm, A, 1 + 0.1 * randn(di), h0


def scan_chunked(x, dt, Bm, Cm, A, D, h0, L):
    """The selective scan in the same three phases (no kernel of the port
    runs it so): the chunk's decay product is that of its per-token
    factors exp(dt A)."""
    S = x.shape[1]
    if S <= L:
        return ref.selective_scan(x, dt, Bm, Cm, A, D, h0)
    chunks = [slice(c, min(c + L, S)) for c in range(0, S, L)]
    loc, decay = [], []
    for sl in chunks[:-1]:
        _, h_end = ref.selective_scan(x[:, sl], dt[:, sl], Bm[:, sl],
                                      Cm[:, sl], A, D, torch.zeros_like(h0))
        loc.append(h_end)
        p = torch.ones_like(h0)
        for t in range(sl.start, sl.stop):
            p = p * torch.exp(dt[:, t, :, None] * A)
        decay.append(p)
    h_in = [h0]
    for h_loc, p in zip(loc, decay):
        h_in.append(p * h_in[-1] + h_loc)
    ys = []
    for sl, hc in zip(chunks, h_in):
        y, h_fin = ref.selective_scan(x[:, sl], dt[:, sl], Bm[:, sl],
                                      Cm[:, sl], A, D, hc)
        ys.append(y)
    return torch.cat(ys, dim=1), h_fin


@pytest.mark.parametrize("label,B,S,lens,L,carried", CASES,
                         ids=[c[0] for c in CASES])
def test_wkv6_three_phases_match_token_walk(label, B, S, lens, L, carried):
    rng = np.random.default_rng(7)
    args = _wkv_inputs(rng, B, S, 3, lens, carried)
    r, k, v, w, u, S0 = args
    want = ref.wkv6(*args)
    got = wkv6_chunked(*args, L)
    weight = ref.wkv6(r.abs(), k.abs(), v.abs(), w, u.abs(), S0.abs())
    for g, x, m in zip(got, want, weight):
        assert g.shape == x.shape
        assert bool(((g - x).abs() <= WKV_RTOL * m + WKV_ATOL).all())
    # a carry that drops a chunk's decay product must fail that bar
    if S > L:
        bad_w = w.clone()
        bad_w[:, L] = 1.0                  # the first token of chunk 1
        bad = wkv6_chunked(r, k, v, bad_w, u, S0, L)
        assert not all(bool(((g - x).abs() <= WKV_RTOL * m + WKV_ATOL).all())
                       for g, x, m in zip(bad, want, weight))


def _grads_close(got, want):
    """Each gradient within WKV_GRAD_ERR of its max |grad| with a cosine
    >= WKV_GRAD_COS (kernel B's bar on the card, chip_smoke.py)."""
    return all(
        (g - x).abs().max().item() <= WKV_GRAD_ERR * x.abs().max().item()
        and torch.nn.functional.cosine_similarity(
            g.flatten(), x.flatten(), dim=0).item() >= WKV_GRAD_COS
        for g, x in zip(got, want))


@pytest.mark.parametrize("label,B,S,lens,L,carried", CASES,
                         ids=[c[0] for c in CASES])
def test_wkv6_backward_phases_match_the_reverse_loop(label, B, S, lens, L,
                                                     carried):
    """Kernel B's algebra (``wkv6_bwd_chunked``) against the plain
    reverse loop ``ref.wkv6_bwd``, with dy and the final state's gradient
    non-zero: in the forward's chunks of L, and as one chunk (the decay's
    gradient from the suffix sum alone, no stored state); the three
    planted faults (u's term dropped from dk, the decay sum's carry over
    chunks dropped, lam's carry dropped) must fail the bar where there
    are chunks to carry over."""
    rng = np.random.default_rng(13)
    r, k, v, w, u, S0 = _wkv_inputs(rng, B, S, 3, lens, carried)
    dy = torch.from_numpy(rng.standard_normal(r.shape).astype(np.float32))
    dS = torch.from_numpy(rng.standard_normal(S0.shape).astype(np.float32))
    want = ref.wkv6_bwd(r, k, v, w, u, S0, dy, dS)
    assert _grads_close(wkv6_bwd_chunked(r, k, v, w, u, S0, dy, dS, L),
                        want)
    assert _grads_close(wkv6_bwd_chunked(r, k, v, w, u, S0, dy, dS, S),
                        want)
    faults = (("u_in_dk", "decay_carry", "a_end", "lam_carry") if S > L
              else ("u_in_dk", "a_end"))
    for fault in faults:
        bad = wkv6_bwd_chunked(r, k, v, w, u, S0, dy, dS, L, fault)
        assert not _grads_close(bad, want), fault


# kernel B at whole channels of near-zero decay, w = exp(-exp(N(2, 0.5)))
# (about 1e-3 and far below): dlogw there is a difference of suffix sums
# far larger than itself, so each channel's dlogw is held against the
# float64 truth on its own scale, a relative L2 over its tokens
WKV_DLOGW_REL = 2.0 ** -8


def near_zero_decays(rng, w, head: int, channels: int):
    """``w`` with its first ``channels`` channels of ``head`` decaying
    near 0 at every valid token (w stays 1 past a row's length)."""
    z = torch.from_numpy(np.exp(-np.exp(rng.normal(
        2.0, 0.5, w.shape[:2] + (channels,)))).astype(np.float32))
    out = w.clone()
    out[:, :, head, :channels] = torch.where(
        w[:, :, head, :channels] == 1.0, 1.0, z)
    return out


def dlogw_rel_by_channel(got, want):
    """Relative L2 of dlogw (B, S, H, N) over batch and tokens, per (head,
    channel), against a float64 ``want``."""
    got, want = got.double(), want.double()
    return (((got - want) ** 2).sum((0, 1)).sqrt()
            / (want ** 2).sum((0, 1)).sqrt())


@pytest.mark.parametrize("L", [32, 64])
def test_wkv6_backward_near_zero_decays(L):
    """Kernel B's algebra in float32 (the kernel's precision) where whole
    channels decay near 0, beside channels drawn as usual: every
    channel's dlogw within WKV_DLOGW_REL of the float64 reverse loop on
    its own scale, and the other gradients within the kernel's bar."""
    rng = np.random.default_rng(29)
    r, k, v, w, u, S0 = _wkv_inputs(rng, 2, 200, 2, (200, 150), True)
    w = near_zero_decays(rng, w, 0, 8)
    dy = torch.from_numpy(rng.standard_normal(r.shape).astype(np.float32))
    dS = torch.from_numpy(rng.standard_normal(S0.shape).astype(np.float32))
    want = ref.wkv6_bwd(*(t.double() for t in (r, k, v, w, u, S0, dy, dS)))
    got = wkv6_bwd_chunked(r, k, v, w, u, S0, dy, dS, L)
    rel = dlogw_rel_by_channel(got[3], want[3])
    assert float(rel.max()) <= WKV_DLOGW_REL, rel
    # the regime is reached: those channels' dlogw is tiny beside the rest
    # (row 0, whose every token is valid)
    assert float(want[3][0, :, 0, :8].abs().mean()) < \
        1e-2 * float(want[3][0, :, 0, 8:].abs().mean())
    assert _grads_close([g for i, g in enumerate(got) if i != 3],
                        [x.float() for i, x in enumerate(want) if i != 3])


def scan_bwd_chunked(x, dt, Bm, Cm, A, D, h0, dy, dh, L, sub=8, group=32,
                     fault=None, ckpt=None):
    """Kernel D's phases in plain PyTorch: the checkpoints (the state
    before each chunk of L tokens, as kernel C stores them; ``ckpt``, a
    (Bt, chunks, di, 16) tensor, gives them instead), then the
    chunks in reverse, each rerun from its checkpoint with its sub-chunk
    starts kept, the sub-chunks in reverse rerun and g walked back over
    them; dB and dC as per-group partials over ``group`` channels (a
    CTA's) summed over the groups in order, dA and dD per row summed over
    the rows.  ``fault``: "group_partial_dropped" (the last group left
    out), "ckpt_ignored" or "g_carry_dropped"."""
    Bt, S, di = x.shape
    chunks = [(c, min(c + L, S)) for c in range(0, S, L)]
    if ckpt is None:
        states, h = [], h0
        for t0, t1 in chunks:
            states.append(h)
            _, h = ref.selective_scan(x[:, t0:t1], dt[:, t0:t1],
                                      Bm[:, t0:t1], Cm[:, t0:t1], A, D, h)
        ckpt = torch.stack(states, dim=1)
    n_grp = -(-di // group)

    def by_group(v):           # (Bt, di, 16) -> (n_grp, Bt, 16)
        v = torch.nn.functional.pad(v, (0, 0, 0, n_grp * group - di))
        return v.view(Bt, n_grp, group, 16).sum(2).transpose(0, 1)

    def advance(h, t):
        a = torch.exp(dt[:, t, :, None] * A)
        return a, a * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    part = x.new_zeros((n_grp, Bt, S, 2, 16))
    dA_rows, dD_rows = x.new_zeros((Bt, di, 16)), x.new_zeros((Bt, di))
    G = dh.clone()
    for ci in reversed(range(len(chunks))):
        t0, t1 = chunks[ci]
        if fault == "g_carry_dropped" and ci == len(chunks) - 2:
            G = torch.zeros_like(G)
        h = (torch.zeros_like(h0) if fault == "ckpt_ignored"
             else ckpt[:, ci])
        starts = []
        for s0 in range(t0, t1, sub):
            starts.append(h)
            for t in range(s0, min(s0 + sub, t1)):
                h = advance(h, t)[1]
        for si in reversed(range(len(starts))):
            s0 = t0 + si * sub
            hp, ea, hc = [], [], starts[si]
            for t in range(s0, min(s0 + sub, t1)):
                hp.append(hc)
                a, hc = advance(hc, t)
                ea.append(a)
            for u in reversed(range(len(hp))):
                t = s0 + u
                dtx = (dt[:, t] * x[:, t])[..., None]
                w = ea[u] * hp[u]
                ht = w + dtx * Bm[:, t, None, :]
                g = G + Cm[:, t, None, :] * dy[:, t, :, None]
                sx = (g * Bm[:, t, None, :]).sum(-1)
                dx[:, t] = dt[:, t] * sx + D * dy[:, t]
                ddt[:, t] = (g * A * w).sum(-1) + x[:, t] * sx
                dA_rows += g * dt[:, t, :, None] * w
                dD_rows += dy[:, t] * x[:, t]
                part[:, :, t, 0] = by_group(g * dtx)
                part[:, :, t, 1] = by_group(dy[:, t, :, None] * ht)
                G = ea[u] * g
    if fault == "group_partial_dropped":
        part = part[:-1]
    sums = part[0].clone()
    for p in part[1:]:
        sums += p
    return (dx, ddt, sums[:, :, 0], sums[:, :, 1], dA_rows.sum(0),
            dD_rows.sum(0), G)


@pytest.mark.parametrize("label,B,S,lens,L,carried", CASES,
                         ids=[c[0] for c in CASES])
def test_scan_backward_phases_match_the_reverse_loop(label, B, S, lens, L,
                                                     carried):
    """Kernel D's algebra (``scan_bwd_chunked``) against the plain reverse
    loop ``ref.selective_scan_bwd``, with dy and the final state's
    gradient non-zero: in chunks of L and as one chunk; the planted
    faults must fail the bar where there are chunks to carry over (a
    group's partial always)."""
    rng = np.random.default_rng(17)
    x, dt, Bm, Cm, A, D, h0 = _scan_inputs(rng, B, S, 24, lens, carried)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal(h0.shape).astype(np.float32))
    args = (x, dt, Bm, Cm, A, D, h0, dy, dh)
    want = ref.selective_scan_bwd(*args)
    assert _grads_close(scan_bwd_chunked(*args, L), want)
    assert _grads_close(scan_bwd_chunked(*args, S), want)
    # several groups, the last ragged: 24 channels in groups of 10
    assert _grads_close(scan_bwd_chunked(*args, L, group=10), want)
    faults = (("group_partial_dropped", "ckpt_ignored", "g_carry_dropped")
              if S > L else ("group_partial_dropped",))
    for fault in faults:       # 3 groups of 8 channels
        assert not _grads_close(scan_bwd_chunked(*args, L, group=8,
                                                 fault=fault), want), fault
    assert not _grads_close(scan_bwd_chunked(
        *args, L, group=10, fault="group_partial_dropped"), want)


@pytest.mark.parametrize("label,B,S,lens,L,carried", CASES,
                         ids=[c[0] for c in CASES])
def test_scan_three_phases_match_token_walk(label, B, S, lens, L, carried):
    rng = np.random.default_rng(11)
    args = _scan_inputs(rng, B, S, 24, lens, carried)
    want = ref.selective_scan(*args)
    got = scan_chunked(*args, L)
    for g, x in zip(got, want):
        assert g.shape == x.shape
        assert bool(((g - x).abs() <= SCAN_ATOL + SCAN_RTOL * x.abs()).all())
    # the chunk carries must matter: phase 3 from zero states fails
    if S > L:
        x_, dt, Bm, Cm, A, D, h0 = args
        y0, _ = ref.selective_scan(x_[:, L:], dt[:, L:], Bm[:, L:],
                                   Cm[:, L:], A, D, torch.zeros_like(h0))
        assert not bool(((y0 - want[0][:, L:]).abs()
                         <= SCAN_ATOL + SCAN_RTOL * want[0][:, L:].abs()
                         ).all())


@pytest.mark.parametrize("B,S,H,sms,want", [
    (1, 16384, 32, 132, 512),     # rwkv6-1.6b's first prefill window
    (4, 1000, 32, 132, 112),      # chip_smoke.py's padded window
    (1, 4096, 32, 132, 128),      # its one-row window
    (4, 1, 32, 132, 64)])         # the decode step: one pass
def test_wkv6_chunk_length(B, S, H, sms, want):
    """The kernel's chunk length: a multiple of its stage, at least
    WKV_MIN_CHUNK, one pass (L >= S) for a window of at most one chunk,
    and otherwise about WKV_CTAS_PER_SM CTAs an SM."""
    L = ops.wkv6_chunk(B, S, H, sms)
    assert L == want
    assert L % ops.WKV_STAGE == 0 and L >= ops.WKV_MIN_CHUNK
    if S > L:
        ctas = B * H * -(-S // L)
        assert ctas <= ops.WKV_CTAS_PER_SM * sms + B * H
        assert ctas * 2 > ops.WKV_CTAS_PER_SM * sms
