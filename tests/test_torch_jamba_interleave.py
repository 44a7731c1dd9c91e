"""jamba-v0.1-52b at the smoke's widths over 8 layers with the full
config's interleave (period 8, offset 4: one attention layer, model
layer 4, so KV layer 0 is model layer 4; MoE on the odd layers, after
Mamba mixers) on the oracle and baseline paths, in the port against the
reference, on the CPU: ``test_torch_jamba_paths.py``'s checks (greedy
tokens, ``TransferStats``, modelled clock, prefill watermark) on the
split plane, the persistent, stacked and sequential decodes, the legacy
prefill executor and the chunked baseline."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from test_torch_jamba_paths import (PATHS, check_path, configs,  # noqa: F401
                                    one_thread)

INTERLEAVE = dict(num_layers=8, attn_layer_period=8, attn_layer_offset=4,
                  moe_layer_period=2)


@pytest.fixture(scope="module")
def pair():
    jc, tc = configs(**INTERLEAVE)
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                           device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_matches_reference(path, pair):
    check_path(path, pair)
