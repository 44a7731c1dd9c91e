"""internvl2-2b (the VLM: a prefix of patch embeddings ahead of the
prompt) in the port against the reference, on the CPU.

The smoke config (2 layers, d 256, 4 query heads over 2, 8 patches) in
float32, the reference's weights handed over through ``bridge.py``, the
patch embeddings and prompts drawn from a numpy seed.  A reduced DSA
config (block 8, budget 32 -> top-4 blocks) makes the selection drop
blocks.

- ``embed_inputs`` and ``prefill_embed`` with patches: the same hidden
  stream and positions, exactly (a gather and a concatenation);
- prefill and decode logits of the whole model, atol 1e-4 (float32 sums
  in another order), the selected block sets exactly;
- the reference's teacher-force bar (``tests/test_consistency.py``):
  prefill(t0..tn-1) + decode(tn) equals prefill(t0..tn), rtol = atol =
  5e-3 as there;
- the engine's greedy tokens, ``TransferStats`` and modelled clock
  against the JAX ``ServingEngine`` on the same submissions on the
  device-plane paths (mixed, split, persistent, the int8 tier, a 1-block
  LRU on both tiers); the stacked, sequential, legacy and chunked paths
  are in ``test_torch_vlm_paths.py``;
- the reference's ``test_engine_on_nontrivial_arch_families`` case;
- the host pool sized for the prompt, the new tokens and the patches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.models.common import DSAConfig as JDSA
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models.common import DSAConfig as TDSA
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

ARCH = "internvl2-2b"
ATOL = 1e-4
PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 4
PATHS = {
    "mixed": {},
    "split": {"hybrid_plane": "split"},
    "persistent": {"decode_plane": "persistent"},
    "int8": {"offload_quant": "int8"},
    "int8_lru1": {"offload_quant": "int8", "hbm_blocks_per_request": 1},
    "lru1": {"hbm_blocks_per_request": 1},
}
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


def _patches(cfg, rng, B=1):
    return rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(
        np.float32)


def _inputs(toks, patches):
    return ({"tokens": jnp.asarray(toks), "patch_embeds":
             jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks), "patch_embeds":
             torch.from_numpy(patches)})


def test_config_admitted_and_bridged(pair):
    jc, tc, jp, tp = pair
    TM.check_supported(tc)
    assert (tc.arch_type, tc.frontend, tc.num_patches) == \
        ("vlm", "vit_patch_stub", 8)
    assert set(tp) == {"embed", "final_norm", "layers", "lm_head"}
    for i in range(tc.num_layers):
        np.testing.assert_array_equal(
            tp["layers"][i]["attn"]["wq"].numpy(),
            np.asarray(jp["layers"]["attn"]["wq"][i]))


def test_embed_inputs_with_patches(pair):
    """The patches (cast to the embeddings' dtype) lead the tokens, the
    positions run over both: exactly the reference's."""
    jc, tc, jp, tp = pair
    r = np.random.default_rng(1)
    toks = r.integers(4, jc.vocab_size, (2, 13)).astype(np.int32)
    ji, ti = _inputs(toks, _patches(jc, r, 2))
    jh, jpos = JM.embed_inputs(jp, jc, ji)
    th, tpos = TM.embed_inputs(tp, tc, ti)
    assert th.shape == (2, 13 + tc.num_patches, tc.d_model)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jh, jpos, jenc = JM.prefill_embed(jp, jc, ji)
    th, tpos, tenc = TM.prefill_embed(tp, tc, ti)
    assert tenc is None and jenc is None
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_prefill_and_decode_logits_match(pair):
    jc, tc, jp, tp = pair
    r = np.random.default_rng(2)
    S, steps, nb = 29, 4, 8
    toks = r.integers(4, jc.vocab_size, (2, S)).astype(np.int32)
    ji, ti = _inputs(toks, _patches(jc, r, 2))
    jl, jst = JM.prefill(jp, jc, ji, nb, cache_dtype=jnp.float32)
    tl, tst = TM.prefill(tp, tc, ti, nb, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tst["cur_len"][0]) == S + tc.num_patches
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst, jinfo = _jax_decode_step(jp, jc, jnp.asarray(nxt), jst)
        tl, tst, tinfo = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst,
                                        return_info=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for layer in range(jc.num_layers):
            jsel = np.asarray(jinfo["selected"][layer])
            tsel = tinfo["selected"][layer].numpy()
            for b in range(2):
                for h in range(tc.num_kv_heads):
                    assert set(tsel[b, h].ravel()) == \
                        set(jsel[b, h].ravel())


def test_vlm_patch_prefix_positions(pair):
    """The reference's teacher-force bar on the port, at the smoke
    config's own DSA settings (every block selected): the incremental
    decode after the patch prefix equals the full-sequence prefill."""
    _, tc, _, tp = pair
    tc = torch_smoke(ARCH)
    S = 64
    toks = np.random.default_rng(1).integers(4, tc.vocab_size,
                                             S + 1).astype(np.int32)
    patches = torch.ones((1, tc.num_patches, tc.d_model)) * .01
    nb = (S + 1 + tc.num_patches) // tc.dsa.block_size + 2
    full, _ = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks[None]),
                                  "patch_embeds": patches}, nb,
                         cache_dtype=torch.float32)
    part, state = TM.prefill(tp, tc,
                             {"tokens": torch.from_numpy(toks[None, :-1]),
                              "patch_embeds": patches}, nb,
                             cache_dtype=torch.float32)
    dec, _ = TM.decode_step(tp, tc, torch.from_numpy(toks[-1:]), state)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3,
                               atol=5e-3)


def _run(engine_cls, config_cls, request_cls, cfg, params, **kw):
    eng = engine_cls(params, cfg, config_cls(r_max=4, chunk_size=64, **kw))
    rng = np.random.default_rng(7)
    ids = []
    for p, t in zip(PROMPTS, ARRIVALS):
        r = request_cls(prompt_len=p, max_new_tokens=GEN, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32), patch_embeds=_patches(cfg, rng))
        ids.append(r.req_id)
    metrics = eng.run()
    return (eng, [eng.states[i].out_tokens for i in ids],
            dataclasses.asdict(eng.transfer_stats()), metrics)


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_matches_reference(path, pair):
    """Greedy tokens, every TransferStats counter and the modelled clock
    equal the JAX engine's on each single-device path."""
    jc, tc, jp, tp = pair
    kw = PATHS[path]
    j_eng, j_tokens, j_stats, j_m = _run(JEngine, JEngineConfig, JRequest,
                                         jc, jp, **kw)
    eng, t_tokens, t_stats, t_m = _run(ServingEngine, EngineConfig, Request,
                                       tc, tp, **kw)
    assert t_tokens == j_tokens
    assert all(len(t) == GEN for t in t_tokens)
    assert t_stats == j_stats
    assert t_m.mean_ttft == pytest.approx(j_m.mean_ttft, rel=1e-9)
    assert t_m.mean_tbt == pytest.approx(j_m.mean_tbt, rel=1e-9)
    assert eng.prefill_hbm_peak_tokens == j_eng.prefill_hbm_peak_tokens
    assert len(eng.planes) == len(j_eng.planes)
    assert len(eng.prefill_planes) == len(j_eng.prefill_planes)
    if path == "mixed":
        # every admission is a frontend request: none takes the batched
        # embed, each is embedded with its patches alone
        assert eng.admit_embed_launches == j_eng.admit_embed_launches == 0
    if path == "lru1":
        assert t_stats["evictions"] > 0
        assert eng.plane.blocks_restored_before_use > 0
    assert sum(ops.launches.snapshot().values()) == 0


def test_host_pool_counts_the_patches(pair):
    jc, tc, jp, tp = pair
    j_eng = JEngine(jp, jc, JEngineConfig())
    t_eng = ServingEngine(tp, tc, EngineConfig())
    rng = np.random.default_rng(3)
    for eng, req in ((j_eng, JRequest), (t_eng, Request)):
        eng.submit(req(prompt_len=40, max_new_tokens=3, req_id="r"),
                   patch_embeds=_patches(tc, rng))
    assert t_eng.states["r"].num_blocks == j_eng.states["r"].num_blocks == \
        -(-(40 + 3 + tc.num_patches) // tc.dsa.block_size) + 1
    assert t_eng.kv_mgr.pools["r"].k.shape == j_eng.kv_mgr.pools["r"].k.shape
    t_eng.close()


def test_engine_on_nontrivial_arch_families():
    """The reference's case for the VLM family (``tests/test_engine.py``):
    one request with its patch embeddings served end to end on the
    default path."""
    cfg = torch_smoke(ARCH)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    eng = ServingEngine(params, cfg, EngineConfig(r_max=2))
    r = Request(prompt_len=64, max_new_tokens=4)
    eng.submit(r, patch_embeds=np.ones((1, cfg.num_patches, cfg.d_model),
                                       np.float32) * .01)
    m = eng.run()
    assert m.num_finished == 1
    assert len(eng.states[r.req_id].out_tokens) == 4
