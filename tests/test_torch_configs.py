"""The configs the port serves beyond qwen2-0.5b and llama3-8b: lwm-7b
(the paper's main model, MHA: G = 1 over 32 kv heads), qwen2.5-3b (GQA
with kv 2 and QKV bias), granite-20b (MQA: 48 query heads over one kv
head), and the MoE family: kimi-k2-1t-a32b (G 8 at head_dim 112; 384
experts top-8 in the full config, 4 top-2 in the smoke) and arctic-480b
(G 7 at 128; top-2 with a dense residual); minicpm3-4b (MLA) is checked
against the reference config here and as a model in ``test_torch_mla.py``;
the MoE function itself in ``test_torch_moe.py``; the frontend families
(internvl2-2b's patch prefix, whisper-small's encoder-decoder) against
the reference configs here, as models in ``test_torch_vlm.py`` and
``test_torch_whisper.py``.

Each arch runs in two variants against the reference model, with the
reference's float32 weights handed over through ``bridge.py``: its
``smoke_config()``, and ``heads``, the smoke's two narrow layers with the
full config's query heads, kv heads and head_dim (so G = 1 with 32 kv
heads, head_dim 128 with QKV bias, and G = 48 over one kv head run here
on the CPU, and kimi-k2's 64 heads of 112).  The QKV biases are drawn at random (the reference
initialises them to zero, which would hide them).  Logits are held with
``test_torch_model.py``'s atol 1e-4 and the selected block sets exactly,
under teacher forcing.  The engine's greedy tokens and ``TransferStats``
on these archs are in ``test_torch_engine.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_cfg
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as torch_cfg
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import model as TM

ARCHS = ["lwm-7b", "qwen2.5-3b", "granite-20b", "kimi-k2-1t-a32b",
         "arctic-480b"]
# (query heads, kv heads, head_dim, QKV bias) of the full configs;
# minicpm3-4b (MLA) has its model tests in test_torch_mla.py
FULL_HEADS = {"lwm-7b": (32, 32, 128, False),
              "qwen2.5-3b": (16, 2, 128, True),
              "granite-20b": (48, 1, 128, False),
              "kimi-k2-1t-a32b": (64, 8, 112, False),
              "arctic-480b": (56, 8, 128, False),
              "minicpm3-4b": (40, 40, 64, False),
              "internvl2-2b": (16, 8, 128, False),
              "whisper-small": (12, 12, 64, False)}
# the frontend families' own fields of the full configs
FRONTENDS = {"internvl2-2b": ("vlm", "vit_patch_stub", 256, False, 0, 24),
             "whisper-small": ("audio", "audio_conv_stub", 256, True, 12,
                               12)}
LOGIT_ATOL = 1e-4
_jax_decode_step = jax.jit(
    lambda p, c, t, s: JM.decode_step(p, c, t, s, return_info=True),
    static_argnums=1)


def _variant(cfg, full, variant):
    cfg = dataclasses.replace(cfg, dsa=type(cfg.dsa)(block_size=8,
                                                     token_budget=32))
    if variant == "heads":
        cfg = dataclasses.replace(cfg, num_heads=full.num_heads,
                                  num_kv_heads=full.num_kv_heads,
                                  head_dim=full.head_dim)
    return cfg


@pytest.fixture(scope="module")
def pair():
    cache = {}

    def get(arch, variant):
        if (arch, variant) not in cache:
            jc = _variant(jax_smoke(arch), jax_cfg(arch), variant)
            tc = _variant(torch_smoke(arch), torch_cfg(arch), variant)
            jp = jax.tree.map(np.asarray, JM.init_params(
                jc, jax.random.PRNGKey(0), jnp.float32))
            r = np.random.default_rng(5)
            attn = jp["layers"]["attn"]
            for name in ("bq", "bk", "bv"):
                if name in attn:
                    attn[name] = (0.5 * r.standard_normal(attn[name].shape)
                                  ).astype(np.float32)
            tp = params_from_numpy(jp, jc.num_layers, device="cpu")
            cache[arch, variant] = (jc, tc, jax.tree.map(jnp.asarray, jp),
                                    tp)
        return cache[arch, variant]
    return get


@pytest.mark.parametrize("arch", ARCHS + ["minicpm3-4b"] + list(FRONTENDS))
def test_config_is_the_reference_config(arch):
    assert arch in ALL_ARCHS
    assert dataclasses.asdict(torch_cfg(arch)) == \
        dataclasses.asdict(jax_cfg(arch))
    assert dataclasses.asdict(torch_smoke(arch)) == \
        dataclasses.asdict(jax_smoke(arch))
    cfg = torch_cfg(arch)
    TM.check_supported(cfg)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.qkv_bias) == FULL_HEADS[arch]
    if arch in FRONTENDS:
        assert (cfg.arch_type, cfg.frontend, cfg.num_patches,
                cfg.is_encoder_decoder, cfg.encoder_layers,
                cfg.num_layers) == FRONTENDS[arch]


@pytest.mark.parametrize("variant", ["smoke", "heads"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match(arch, variant, pair):
    jc, tc, jp, tp = pair(arch, variant)
    if variant == "heads":
        assert (tc.num_heads, tc.num_kv_heads, tc.head_dim) == \
            FULL_HEADS[arch][:3]
    if tc.qkv_bias:
        assert tp["layers"][0]["attn"]["bq"].abs().max() > 0
    r = np.random.default_rng(1)
    S, steps, nb = 37, 5, 8
    toks = r.integers(4, jc.vocab_size, (2, S)).astype(np.int32)
    jl, jst = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, nb,
                         cache_dtype=jnp.float32)
    tl, tst = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, nb,
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst, jinfo = _jax_decode_step(jp, jc, jnp.asarray(nxt), jst)
        tl, tst, tinfo = TM.decode_step(tp, tc, torch.from_numpy(nxt), tst,
                                        return_info=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        for layer in range(jc.num_layers):
            jsel = np.asarray(jinfo["selected"][layer])
            tsel = tinfo["selected"][layer].numpy()
            for b in range(2):
                for h in range(tc.num_kv_heads):
                    assert set(tsel[b, h].ravel()) == \
                        set(jsel[b, h].ravel())
    assert int(tst["cur_len"][0]) == S + steps
