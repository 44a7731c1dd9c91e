"""whisper-small (the encoder-decoder: a bidirectional encoder over the
stubbed frontend's frames, cross-attention in every decoder layer) in
the port against the reference, on the CPU.

The smoke config (2 decoder and 2 encoder layers, d 128, 4 heads over
4) in float32, the reference's weights handed over through
``bridge.py`` (the encoder, ``cross`` and ``cross_norm`` included), the
frames and prompts drawn from a numpy seed.  A reduced DSA config (block
8, budget 32 -> top-4 blocks) makes the decoder's selection drop blocks.

- ``sinusoidal_positions``, atol 1e-5 (float32 sin and cos of two
  libraries);
- ``ops.flash_prefill(causal=False)`` (its plain version on the CPU)
  against ``flash_attention_jnp(causal=False)`` at Sq = 1, a ragged Sk
  over two key chunks and a GQA group of 2, atol 1e-5 (float32);
- ``whisper_encode``, ``project_encoder_kv``, ``cross_attention``,
  ``cross_decode_step``, ``prefill_embed`` and one decoder layer's
  prefill (``layer_forward``) and decode (select, then attend) with its
  cross keys and values, atol 1e-4 (float32 sums in another order);
- prefill and decode logits of the whole model, atol 1e-4, the selected
  block sets exactly;
- the reference's bars on the port: the teacher-force check
  (``tests/test_consistency.py``, rtol = atol = 5e-3 as there), two
  prefill planes for unequal encoder lengths with plane == legacy
  (``tests/test_prefill_plane.py``), two decode planes in one mixed walk
  with mixed == split (``tests/test_hybrid_plane.py``), and
  ``test_engine_on_nontrivial_arch_families``'s case.

The engine against the JAX engine on every path is in
``test_torch_whisper_engine.py``, ``test_torch_whisper_paths.py`` and
``test_torch_whisper_oracles.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro.models.common import sinusoidal_positions as j_sinusoidal
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.models.common import sinusoidal_positions
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

ARCH = "whisper-small"
ATOL = 1e-4
FLASH_ATOL = 1e-5
S_ENC = 24
_jax_decode_step = jax.jit(
    lambda p, c, t, s: JM.decode_step(p, c, t, s, return_info=True),
    static_argnums=1)


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jax_smoke(ARCH),
                             dsa=JDSA(block_size=8, token_budget=32))
    tc = dataclasses.replace(torch_smoke(ARCH),
                             dsa=TDSA(block_size=8, token_budget=32))
    jp = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(0), jnp.float32))
    tp = params_from_numpy(jp, jc.num_layers, device="cpu")
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


def _frames(cfg, rng, B=1, S=S_ENC):
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


def _layer(jp, tp, i=0):
    return jax.tree.map(lambda a: a[i], jp["layers"]), tp["layers"][i]


def test_config_admitted_and_bridged(pair):
    jc, tc, jp, tp = pair
    TM.check_supported(tc)
    assert (tc.is_encoder_decoder, tc.frontend, tc.encoder_layers) == \
        (True, "audio_conv_stub", 2)
    assert set(tp["layers"][1]) == {"attn_norm", "ffn_norm", "attn",
                                    "cross_norm", "cross", "ffn"}
    assert set(tp["layers"][1]["cross"]) == {"wq", "wk", "wv", "wo"}
    np.testing.assert_array_equal(tp["layers"][1]["cross"]["wk"].numpy(),
                                  np.asarray(jp["layers"]["cross"]["wk"][1]))
    np.testing.assert_array_equal(tp["layers"][1]["cross_norm"].numpy(),
                                  np.asarray(jp["layers"]["cross_norm"][1]))
    enc = tp["encoder"]
    assert len(enc["layers"]) == tc.encoder_layers
    np.testing.assert_array_equal(
        enc["layers"][1]["attn"]["wv"].numpy(),
        np.asarray(jp["encoder"]["layers"][1]["attn"]["wv"]))
    np.testing.assert_array_equal(enc["final_norm"].numpy(),
                                  np.asarray(jp["encoder"]["final_norm"]))


def test_sinusoidal_positions():
    np.testing.assert_allclose(sinusoidal_positions(1500, 128).numpy(),
                               np.asarray(j_sinusoidal(1500, 128)),
                               atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 1, 37, 4, 4, 64),          # one decode token per row
    (1, 19, 45, 4, 2, 16),         # GQA group of 2, ragged Sk
    (1, 40, 600, 4, 2, 32),        # two key chunks of 512, the last ragged
])
def test_flash_prefill_noncausal_matches_reference(B, Sq, Sk, Hq, Hkv, D):
    """Every query over every key j < Sk; q_offset is ignored."""
    r = np.random.default_rng(Sq + Sk)
    q = r.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = r.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = r.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    want = JA.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=D ** -0.5,
                                  causal=False)
    for q_offset in (0, 7):
        got = ops.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale=D ** -0.5,
                                causal=False, q_offset=q_offset)
        _close(got, want, FLASH_ATOL)
    assert sum(ops.launches.snapshot().values()) == 0


def test_whisper_encode_and_encoder_kv_match(pair):
    jc, tc, jp, tp = pair
    frames = _frames(jc, np.random.default_rng(1), B=2)
    j_enc = JM.whisper_encode(jp, jc, jnp.asarray(frames))
    t_enc = TM.whisper_encode(tp, tc, torch.from_numpy(frames))
    assert t_enc.shape == (2, S_ENC, tc.d_model)
    _close(t_enc, j_enc)
    j_kvs = JM.project_encoder_kv(jp, jc, j_enc)
    t_kvs = TM.project_encoder_kv(tp, tc, torch.from_numpy(
        np.array(j_enc)))
    assert len(t_kvs) == tc.num_layers
    for (tk, tv), (jk, jv) in zip(t_kvs, zip(*j_kvs)):
        assert tk.shape == (2, S_ENC, tc.num_kv_heads, tc.head_dim)
        _close(tk, jk)
        _close(tv, jv)


def test_cross_attention_and_decode_step_match(pair):
    jc, tc, jp, tp = pair
    jl, tl = _layer(jp, tp, 1)
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 13, jc.d_model)).astype(np.float32)
    k = r.standard_normal((2, S_ENC, jc.num_kv_heads,
                           jc.head_dim)).astype(np.float32)
    v = r.standard_normal(k.shape).astype(np.float32)
    _close(TA.cross_attention(tl["cross"], tc, torch.from_numpy(x),
                              torch.from_numpy(k), torch.from_numpy(v)),
           JA.cross_attention(jl["cross"], jc, jnp.asarray(x),
                              jnp.asarray(k), jnp.asarray(v)))
    _close(TA.cross_decode_step(tl["cross"], tc, torch.from_numpy(x[:, 0]),
                                torch.from_numpy(k), torch.from_numpy(v)),
           JA.cross_decode_step(jl["cross"], jc, jnp.asarray(x[:, 0]),
                                jnp.asarray(k), jnp.asarray(v)))


def test_prefill_embed_matches(pair):
    jc, tc, jp, tp = pair
    r = np.random.default_rng(3)
    toks = r.integers(4, jc.vocab_size, (1, 21)).astype(np.int32)
    frames = _frames(jc, r)
    jh, jpos, jenc = JM.prefill_embed(jp, jc, {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    th, tpos, tenc = TM.prefill_embed(tp, tc, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for i in range(tc.num_layers):
        for t, j in zip(TM.index_enc_kvs(tenc, i),
                        JM.index_enc_kvs(jenc, i)):
            _close(t, j)


def test_one_layer_prefill_and_decode_with_cross(pair):
    """A decoder layer over a prompt, then one decode step of it (select,
    then attend), each with the layer's cross keys and values."""
    jc, tc, jp, tp = pair
    jl, tl = _layer(jp, tp, 1)
    r = np.random.default_rng(4)
    S = 21
    x = r.standard_normal((2, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    k = r.standard_normal((2, S_ENC, jc.num_kv_heads,
                           jc.head_dim)).astype(np.float32)
    v = r.standard_normal(k.shape).astype(np.float32)
    jx, _, (jk, jv), _ = JM.layer_forward(
        jl, jc, jnp.asarray(x), jnp.asarray(pos),
        enc_kv=(jnp.asarray(k), jnp.asarray(v)), return_kv=True)
    tx, (tk, tv) = TM.layer_forward(
        tl, tc, torch.from_numpy(x), torch.from_numpy(pos),
        enc_kv=(torch.from_numpy(k), torch.from_numpy(v)), return_kv=True)
    _close(tx, jx)
    _close(tk, jk)
    _close(tv, jv)
    nb = 4
    jcache = JM._prefill_layer_caches(jc, (jk, jv), None, nb, jnp.float32)
    tcache = TM.kv_to_cache(tc, (tk, tv), nb, torch.float32)
    cur = np.asarray([S, S], np.int32)
    xd = r.standard_normal((2, jc.d_model)).astype(np.float32)
    jq, jcache, jidx, jvalid = JM.decode_select_layer(
        jl, jc, jnp.asarray(xd), jcache, jnp.asarray(cur))
    tq, tcache, tidx, tvalid = TM.decode_select_layer(
        tl, tc, torch.from_numpy(xd), tcache, torch.from_numpy(cur))
    _close(tq, jq)
    jo = JM.decode_attend_layer(jl, jc, jnp.asarray(xd), jq, jcache,
                                jnp.asarray(cur), jidx, jvalid,
                                enc_kv=(jnp.asarray(k), jnp.asarray(v)))
    to = TM.decode_attend_layer(
        tl, tc, torch.from_numpy(xd), tq, tcache, torch.from_numpy(cur),
        torch.from_numpy(np.asarray(jidx).astype(np.int32)),
        torch.from_numpy(np.array(jvalid)),
        enc_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    _close(to, jo)


def test_prefill_and_decode_logits_match(pair):
    jc, tc, jp, tp = pair
    r = np.random.default_rng(5)
    S, steps, nb = 29, 4, 8
    toks = r.integers(4, jc.vocab_size, (2, S)).astype(np.int32)
    frames = _frames(jc, r, B=2)
    jl, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(frames)}, nb,
                         cache_dtype=jnp.float32)
    tl, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks),
                                  "frames": torch.from_numpy(frames)}, nb,
                         cache_dtype=torch.float32)
    _close(tl, jl)
    assert len(tst["extra"]["enc_kvs"]) == tc.num_layers
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst, jinfo = _jax_decode_step(jp, jc, jnp.asarray(nxt), jst)
        tl, tst, tinfo = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst,
                                        return_info=True)
        _close(tl, jl)
        for layer in range(jc.num_layers):
            jsel = np.asarray(jinfo["selected"][layer])
            tsel = tinfo["selected"][layer].numpy()
            for b in range(2):
                for h in range(tc.num_kv_heads):
                    assert set(tsel[b, h].ravel()) == \
                        set(jsel[b, h].ravel())


def test_whisper_decode_uses_cached_cross_kv(pair):
    """The reference's teacher-force bar on the port, at the smoke
    config's own DSA settings (every block selected): prefill(t0..tn-1)
    + decode(tn) over the cached cross keys and values equals
    prefill(t0..tn)."""
    _, _, _, tp = pair
    tc = torch_smoke(ARCH)
    S = 64
    toks = np.random.default_rng(1).integers(4, tc.vocab_size,
                                             S + 1).astype(np.int32)
    frames = torch.ones((1, 16, tc.d_model)) * .01
    nb = (S + 1) // tc.dsa.block_size + 2
    full, _ = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks[None]),
                                  "frames": frames}, nb,
                         cache_dtype=torch.float32)
    _, state = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks[None, :-1]),
                                   "frames": frames}, nb,
                          cache_dtype=torch.float32)
    dec, _ = TM.decode_step(tp, tc, torch.from_numpy(toks[-1:]), state)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3,
                               atol=5e-3)


def _run(cfg, params, prompts=(48, 48, 64), enc_lens=(16, 16, 24), gen=3,
         **kw):
    kw.setdefault("r_max", 4)
    kw.setdefault("chunk_size", 64)
    eng = ServingEngine(params, cfg, EngineConfig(**kw))
    rng = np.random.default_rng(7)
    order = []
    for p, s_enc in zip(prompts, enc_lens):
        r = Request(prompt_len=p, max_new_tokens=gen)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32),
                   frames=np.ones((1, s_enc, cfg.d_model), np.float32) * .01)
        order.append(r.req_id)
    eng.run()
    return eng, [eng.states[rid].out_tokens for rid in order]


def test_whisper_groups_by_encoder_length(pair):
    """Requests with unequal encoder KV shapes cannot share a launch: one
    prefill plane per encoder shape, still equal to the legacy
    executor."""
    _, tc, _, tp = pair
    e_p, toks_p = _run(tc, tp)
    _, toks_l = _run(tc, tp, prefill_exec="legacy")
    assert toks_p == toks_l
    assert len(e_p.prefill_planes) == 2
    assert sorted(p.enc[0][0].shape[1]
                  for p in e_p.prefill_planes.values()) == [16, 24]


def test_whisper_two_decode_groups_share_one_walk(pair):
    """Unequal encoder KV shapes split decode into two planes; the mixed
    iteration carries both through one layer walk and still equals
    split."""
    _, tc, _, tp = pair
    e_m, toks_m = _run(tc, tp, max_inject_tokens=4096)
    e_s, toks_s = _run(tc, tp, hybrid_plane="split", max_inject_tokens=4096)
    assert toks_m == toks_s
    assert e_m.hybrid is not None and e_s.hybrid is None
    assert max(e["decode_planes"] for e in e_m.mixed_iter_log) == 2
    assert len(e_m.planes) == len(e_s.planes) == 2
    assert e_m.metrics_snapshot()["plane.count"] == 2.0


def test_engine_on_nontrivial_arch_families():
    """The reference's case for the encoder-decoder family
    (``tests/test_engine.py``): one request with its frames served end
    to end on the default path."""
    cfg = torch_smoke(ARCH)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    eng = ServingEngine(params, cfg, EngineConfig(r_max=2))
    r = Request(prompt_len=64, max_new_tokens=4)
    eng.submit(r, frames=np.ones((1, 16, cfg.d_model), np.float32) * .01)
    m = eng.run()
    assert m.num_finished == 1
    assert len(eng.states[r.req_id].out_tokens) == 4
