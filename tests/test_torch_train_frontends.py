"""Training of the frontend families in the port against the reference's,
on the CPU in float32: internvl2-2b's smoke (a prefix of 8 patch
embeddings ahead of the text; the loss over the text's logits only) and
whisper-small's (the encoder over 16 frames, cross-attention in every
decoder layer), each batch with the reference launcher's frontend
stand-ins (``trainer.frontend_inputs``: ones x 0.01).  One train step's
loss and every gradient leaf against ``jax.value_and_grad`` of the
reference's ``forward_train``, three AdamW steps, remat on and off, the
eval step, and the ``causal`` flag of every attention the step runs; the
plain backward of ``flash_prefill``'s non-causal mode (Sq == Sk, Sq !=
Sk over a ragged Sk past a 512-row chunk, a GQA group) against
``jax.grad`` of ``flash_attention_jnp`` and torch autograd of a naive
attention.  Helpers and tolerances are tests/test_torch_train_mla.py's."""
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.training import trainer as TT
from test_torch_train_mla import (causal_flags, check_one_step,
                                  check_plain_backward, check_remat,
                                  check_steps, one_thread, port_setup,
                                  reference_steps)

B, STEPS = 2, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
SEQ = {"internvl2-2b": 24, "whisper-small": 16}

assert one_thread   # the port on one PyTorch thread here too (autouse)


@pytest.fixture(scope="module", params=sorted(SEQ))
def case(request):
    """(arch, numpy batch with the frontend stand-ins, the reference's
    steps), once per arch."""
    arch = request.param
    cfg = jax_smoke(arch)
    batch_np = JTokenStream(JDataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ[arch], global_batch=B,
        seed=5)).batch()
    batch_np.update(TT.frontend_inputs(torch_smoke(arch), B))
    return arch, batch_np, reference_steps(arch, batch_np, STEPS, OPT)


def test_one_train_step_matches_reference(case):
    arch, batch_np, ref = case
    check_one_step(arch, ref, batch_np, OPT)


def test_three_steps_match_reference(case):
    arch, batch_np, ref = case
    check_steps(arch, ref, batch_np, OPT)


def test_remat_on_and_off_give_the_same_loss_and_gradients(case):
    arch, batch_np, ref = case
    check_remat(arch, ref, batch_np)


def test_eval_step_is_the_forward_loss(case):
    arch, batch_np, ref = case
    cfg, params, batch = port_setup(arch, ref, batch_np)
    loss = TT.make_eval_step(cfg)(params, batch)
    assert not loss.requires_grad
    assert abs(loss.item() - ref["loss0"]) <= 1e-5 * abs(ref["loss0"])


def test_logits_cover_the_text_only(case):
    """The VLM's logits drop the patch prefix, as the reference's
    ``logits[:, -labels.shape[1]:]``; Whisper's cover its tokens."""
    arch, batch_np, ref = case
    from repro_torch.models import model as TM
    cfg, params, batch = port_setup(arch, ref, batch_np)
    _, logits = TM.forward_train(params, cfg, batch, remat=False)
    assert logits.shape == (B, SEQ[arch], cfg.vocab_size)


def test_every_attention_reaches_its_mode(monkeypatch, case):
    """Whisper: the encoder's self-attention non-causal over the frames,
    then each decoder layer's causal self-attention and its non-causal
    cross-attention over the frames (Sq != Sk); the VLM: causal over the
    patches and the text."""
    arch, batch_np, ref = case
    cfg = torch_smoke(arch)
    hd, S = cfg.head_dim, SEQ[arch]
    seen = causal_flags(monkeypatch, arch, ref, batch_np)
    if arch == "whisper-small":
        T = batch_np["frames"].shape[1]
        want = ([(False, T, T, hd, hd)] * cfg.encoder_layers
                + [(True, S, S, hd, hd), (False, S, T, hd, hd)]
                * cfg.num_layers)
    else:
        P = cfg.num_patches
        want = [(True, P + S, P + S, hd, hd)] * cfg.num_layers
    assert seen == want


def test_launcher_stand_ins_are_the_references():
    """frames (B, 16, d) and patch_embeds (B, num_patches, d), float32
    ones x 0.01, as src/repro/launch/train.py makes them."""
    w, v = torch_smoke("whisper-small"), torch_smoke("internvl2-2b")
    fw, fv = TT.frontend_inputs(w, 3), TT.frontend_inputs(v, 3)
    assert set(fw) == {"frames"} and set(fv) == {"patch_embeds"}
    assert fw["frames"].shape == (3, 16, w.d_model)
    assert fv["patch_embeds"].shape == (3, v.num_patches, v.d_model)
    for a in (fw["frames"], fv["patch_embeds"]):
        assert a.dtype == np.float32
        assert np.array_equal(a, np.ones_like(a) * np.float32(0.01))
    assert TT.frontend_inputs(torch_smoke("qwen2-0.5b"), 3) == {}


@pytest.mark.parametrize("Bn,Sq,Sk,Hq,Hkv,D", [
    (2, 37, 37, 4, 4, 32),      # the encoder: Sq == Sk
    (1, 45, 600, 4, 4, 16),     # cross-attention: Sk ragged past 512
    (2, 600, 20, 4, 4, 16),     # Sq past one 512-row chunk, Sk short
    (2, 40, 530, 8, 2, 16)])    # a GQA group, G 4
def test_plain_noncausal_backward(Bn, Sq, Sk, Hq, Hkv, D):
    check_plain_backward(Bn, Sq, Sk, Hq, Hkv, D, D, causal=False)
