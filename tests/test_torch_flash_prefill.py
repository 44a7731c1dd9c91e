"""The port's ``flash_prefill``: the plain PyTorch version (what the
wrapper takes for CPU tensors, and the yardstick of the CUDA kernel on the
card) held against the reference's Pallas ``flash_prefill`` kernel in
interpret mode and its ``flash_attention_jnp``, on the same numpy inputs
made from a seed; and the prefill layer of the prefill plane, which now
reaches attention through ``ops.flash_prefill``.

Cases: GQA groups G = 1, 4, 7 (MHA, llama3-8b's, qwen2-0.5b's), head dims
64 and 128, q_offset 0 and a chunk continuation whose earlier keys lie
ahead of the window (Sk = q_offset + Sq), with query and key lengths that
fill no whole tile (the Pallas kernel pads them).  Everything runs in
float32 on the CPU; the sums run in another order than XLA's over at most
a hundred O(1) terms, so the tolerance is atol 1e-5 / rtol 1e-5.

The CUDA kernel itself runs only on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM

ATOL = RTOL = 1e-5
HKV = 2


def _inputs(seed, B, Sq, Sk, G, D):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Sq, G * HKV, D), dtype=np.float32)
    k = r.standard_normal((B, Sk, HKV, D), dtype=np.float32)
    v = r.standard_normal((B, Sk, HKV, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("q_offset", [0, 24])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7])
def test_plain_flash_prefill_matches_pallas_and_jnp(G, D, q_offset):
    Sq = 37                                  # no whole 16-row tile
    Sk = q_offset + Sq                       # earlier keys ahead
    q, k, v = _inputs(G * 100 + D + q_offset, 2, Sq, Sk, G, D)
    scale = D ** -0.5
    got = ops.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), scale=scale,
                            q_offset=q_offset)
    assert torch.equal(got, ref.flash_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, q_offset=q_offset))
    want_pallas = jops.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale=scale,
                                     q_offset=q_offset, q_tile=16,
                                     k_tile=16)
    want_jnp = jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), scale=scale,
                                         causal=True, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp),
                               atol=ATOL, rtol=RTOL)
    assert ops.launches.counts["flash_prefill"] == 0


def test_plain_flash_prefill_chunks_agree():
    """The plain version's own query/key chunking (512 by default, 16
    here) does not change its result, including key chunks skipped above
    the causal diagonal."""
    q, k, v = _inputs(5, 1, 70, 110, 7, 64)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    whole = ref.flash_prefill(*args, scale=0.125, q_offset=40)
    chunked = ref.flash_prefill(*args, scale=0.125, q_offset=40,
                                q_chunk=16, k_chunk=16)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_prefill_layer_reaches_attention_through_the_wrapper(arch,
                                                             monkeypatch):
    """``prefill_attn_layer_batched`` with earlier-chunk context and a
    padded window tail calls ``ops.flash_prefill`` once, causal, with the
    window's start as q_offset and Sk = q_offset + T, and still matches
    the reference layer."""
    jc, tc = jax_smoke(arch), torch_smoke(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(1), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                           device="cpu")
    r = np.random.default_rng(3)
    B, T, start = 2, 16, 24
    h = r.standard_normal((B, T, jc.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(start, start + T, dtype=np.int32),
                          (B, T)).copy()
    tmask = np.ones((B, T), bool)
    tmask[1, 11:] = False                     # padded window tail
    smask = np.ones((B,), bool)
    kc = r.standard_normal((B, start, jc.num_kv_heads, jc.head_dim),
                           dtype=np.float32)
    vc = r.standard_normal(kc.shape, dtype=np.float32)
    calls = []
    real = ops.flash_prefill

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_prefill", spy)
    to, (tk, tv) = TM.prefill_attn_layer_batched(
        TM.get_layer(tp, 0), tc, torch.from_numpy(h), torch.from_numpy(pos),
        torch.from_numpy(tmask), torch.from_numpy(smask),
        k_ctx=torch.from_numpy(kc), v_ctx=torch.from_numpy(vc),
        q_offset=start)
    jo, (jk, jv) = JM.prefill_attn_layer_batched(
        JM.get_layer(jp, 0), jc, jnp.asarray(h), jnp.asarray(pos),
        jnp.asarray(tmask), jnp.asarray(smask), k_ctx=jnp.asarray(kc),
        v_ctx=jnp.asarray(vc), q_offset=start)
    assert len(calls) == 1
    q_shape, k_shape, kw = calls[0]
    assert q_shape == (B, T, jc.num_heads, jc.head_dim)
    assert k_shape == (B, start + T, jc.num_kv_heads, jc.head_dim)
    assert kw["q_offset"] == start and kw["causal"] is True
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=RTOL)


def test_flash_prefill_wrapper_on_cpu_is_the_plain_version():
    """CPU tensors take the plain version whatever their dtype or mode
    (the non-causal mode included); no kernel launch is counted."""
    q, k, v = _inputs(7, 1, 9, 9, 4, 64)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    for causal in (True, False):
        got = ops.flash_prefill(*args, scale=0.125, causal=causal)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, ref.flash_prefill(*args, scale=0.125,
                                                  causal=causal))
    assert ops.launches.counts["flash_prefill"] == 0
