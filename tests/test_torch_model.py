"""The port's dense GQA model (``repro_torch.models``) against the
reference (``repro.models``) on the qwen2 and llama3 smoke configs, with
the reference's float32 weights handed over through ``bridge.py``.

Both sides run in float32 on the CPU.  Logits are compared with atol 1e-4
(the smoke models' logits are O(1); XLA and PyTorch sum in other orders
through two layers); greedy tokens are compared exactly under teacher
forcing (each step feeds the reference's token, so a near-tie cannot
cascade).  A reduced DSA config (block 8, budget 32 -> top-4 blocks)
makes selection drop blocks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM
from repro_torch.models.common import DSAConfig as TDSA

ARCHS = ["qwen2-0.5b", "llama3-8b"]
_jax_decode_step = jax.jit(
    lambda p, c, t, s: JM.decode_step(p, c, t, s, return_info=True),
    static_argnums=1)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    cache = {}

    def get(arch):
        if arch not in cache:
            jc = dataclasses.replace(jax_smoke(arch),
                                     dsa=JDSA(block_size=8, token_budget=32))
            tc = dataclasses.replace(torch_smoke(arch),
                                     dsa=TDSA(block_size=8, token_budget=32))
            jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                                   jc.num_layers, device="cpu")
            cache[arch] = (jc, tc, jp, tp)
        return cache[arch]
    return get


def test_configs_are_the_reference_configs():
    from repro.configs import get_config as jax_cfg
    from repro_torch.configs import get_config as torch_cfg
    for arch in ARCHS:
        assert dataclasses.asdict(torch_cfg(arch)) == \
            dataclasses.asdict(jax_cfg(arch))
        assert dataclasses.asdict(torch_smoke(arch)) == \
            dataclasses.asdict(jax_smoke(arch))


@pytest.mark.parametrize("causal,q_offset,ctx,Sk_pad", [
    (True, 0, 0, 0), (True, 24, 24, 0), (False, 0, 0, 0), (True, 0, 0, 5)])
def test_flash_attention_matches_reference(causal, q_offset, ctx, Sk_pad):
    """Chunked over queries and keys (chunks of 16 here), GQA G = 7,
    chunk continuation with earlier-chunk context, and key lengths that
    do not fill a key chunk."""
    r = np.random.default_rng(q_offset + Sk_pad)
    B, Sq, Hq, Hkv, D = 2, 40, 14, 2, 16
    Sk = ctx + Sq + Sk_pad if not causal else ctx + Sq
    q = r.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    k = r.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    v = r.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    kw = dict(scale=0.25, causal=causal, q_offset=q_offset, q_chunk=16,
              k_chunk=16)
    got = tref.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    want = jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match(arch, pair):
    jc, tc, jp, tp = pair(arch)
    r = np.random.default_rng(1)
    S, steps, nb = 37, 6, 8
    toks = r.integers(4, jc.vocab_size, (2, S)).astype(np.int32)
    jl, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, nb,
                         cache_dtype=jnp.float32)
    tl, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, nb,
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        assert (np.argmax(tl.numpy(), axis=-1) == nxt).all()
        jl, jst, jinfo = _jax_decode_step(jp, jc, jnp.asarray(nxt), jst)
        tl, tst, tinfo = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst,
                                        return_info=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        for layer in range(jc.num_layers):
            jsel = np.asarray(jinfo["selected"][layer])
            tsel = tinfo["selected"][layer].numpy()
            for b in range(2):
                assert set(tsel[b].ravel()) == set(jsel[b].ravel())
    assert int(tst["cur_len"][0]) == S + steps


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_prefill_layer_and_logits_match(arch, pair):
    """The prefill plane's stage functions: a padded batch window with a
    parked row and right padding, a chunk continuation with context."""
    jc, tc, jp, tp = pair(arch)
    r = np.random.default_rng(2)
    B, T, start = 3, 16, 8
    h = r.standard_normal((B, T, jc.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(start, start + T, dtype=np.int32),
                          (B, T)).copy()
    tmask = np.zeros((B, T), bool)
    tmask[0, :16] = True
    tmask[2, :9] = True
    smask = np.asarray([True, False, True])
    kc = r.standard_normal((B, start, jc.num_kv_heads, jc.head_dim),
                           dtype=np.float32)
    vc = r.standard_normal(kc.shape, dtype=np.float32)
    jo, (jk, jv) = JM.prefill_attn_layer_batched(
        JM.get_layer(jp, 1), jc, jnp.asarray(h), jnp.asarray(pos),
        jnp.asarray(tmask), jnp.asarray(smask), k_ctx=jnp.asarray(kc),
        v_ctx=jnp.asarray(vc), q_offset=start)
    to, (tk, tv) = TM.prefill_attn_layer_batched(
        TM.get_layer(tp, 1), tc, torch.from_numpy(h), torch.from_numpy(pos),
        torch.from_numpy(tmask), torch.from_numpy(smask),
        k_ctx=torch.from_numpy(kc), v_ctx=torch.from_numpy(vc),
        q_offset=start)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    tok_len = np.asarray([16, 3, 9], np.int32)
    np.testing.assert_allclose(
        TM.prefill_logits_batched(tp, tc, torch.from_numpy(h),
                                  torch.from_numpy(tok_len)).numpy(),
        np.asarray(JM.prefill_logits_batched(jp, jc, jnp.asarray(h),
                                             jnp.asarray(tok_len))),
        atol=LOGIT_ATOL)


def test_unsupported_configs_raise():
    from repro_torch.models.common import ModelConfig
    # tied embeddings are served since (tests/test_torch_tied.py): no
    # lm_head leaf; a dense decoder with an attention period still raises;
    # RWKV6's attention-free layers are served: an RWKV config gets the
    # reference's layer kinds
    tied = dataclasses.replace(torch_smoke("qwen2-0.5b"), tie_embeddings=True)
    assert "lm_head" not in TM.init_params(tied, torch.Generator(),
                                           device="cpu")
    periodic = dataclasses.replace(torch_smoke("qwen2-0.5b"),
                                   attn_layer_period=2)
    with pytest.raises(NotImplementedError):
        TM.init_params(periodic, torch.Generator(), device="cpu")
    rwkv = ModelConfig(name="x", arch_type="ssm", num_layers=2, d_model=64,
                       num_heads=0, num_kv_heads=0, d_ff=8, vocab_size=8,
                       attention_type="none")
    assert [TM.layer_kind(rwkv, i) for i in range(2)] == \
        [JM.layer_kind(rwkv, i) for i in range(2)] == ["rwkv", "rwkv"]
    # the MoE FFN and jamba's hybrid layers (mamba mixers, one attention
    # layer in attn_layer_period, MoE every second layer) are served
    # since: a jamba-shaped config gets the reference's layer kinds
    jamba = dataclasses.replace(
        torch_smoke("qwen2-0.5b"), arch_type="hybrid", num_experts=4,
        top_k_experts=2, moe_layer_period=2, attn_layer_period=2,
        attn_layer_offset=1)
    assert [TM.layer_kind(jamba, i) for i in range(jamba.num_layers)] == \
        [JM.layer_kind(jamba, i) for i in range(jamba.num_layers)] == \
        ["mamba", "attn"]
