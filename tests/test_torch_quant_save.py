"""The int8 tier's fused save (``quant_save_blocks``) against the
reference's numpy ``HostPool(quant="int8")``.

1. ``KVCacheManager.flush_fused`` after ``save_new_tokens_fused`` leaves
   every request's int8 pools and scale planes equal, byte for byte, to
   the reference manager's after the same saves and its per-pool
   ``flush``: several requests in one call, a stripe that starts
   mid-block and spans three blocks, whole-block segments, fresh blocks
   with scale 0, and two stripes of one pool on the same block, where
   staging order decides.  ``TransferStats`` and the blocks written agree.
2. The plain version (what ``ops.quant_save_blocks`` takes for CPU
   tensors) on pools already holding data, float32 and bfloat16 stripes,
   against the reference's ``_store_quant_span``.
3. The item packing the CUDA path uploads (segments, addresses, rounds),
   on made-up addresses, and the host-side refusals: an out-of-range
   block or layer raises ``IndexError`` before anything is written, and
   stripes on a device the kernel does not take are refused.

Inputs are made from a seed with numpy; every comparison is exact."""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core import kv_cache as jkv
from repro_torch.core import kv_cache as tkv
from repro_torch.kernels import ops

GEOM = dict(num_layers=2, num_kv_heads=2, block_size=8, head_dim=16)
CAPS = {"a": 40, "b": 24, "c": 33}           # tokens: 5, 3 and 5 blocks
# each step: one save_new_tokens_fused per dict, all before one flush:
# {rid: (start token, tokens)}, for the layer named first
SCENARIOS = {
    "several_requests_whole_blocks": [
        (0, [{"a": (0, 16), "b": (0, 24), "c": (0, 8)}])],
    "stripe_from_mid_block_over_three_blocks": [
        (0, [{"a": (0, 5), "b": (0, 3)}]),
        (0, [{"a": (5, 19), "b": (3, 10), "c": (0, 33)}])],
    "fresh_blocks_scale_zero": [
        (1, [{"a": (0, 1), "b": (17, 1), "c": (32, 1)}])],
    "decode_appends_across_a_block": [
        (1, [{"a": (0, 6), "b": (0, 7), "c": (0, 5)}])] + [
        (1, [{"a": (6 + i, 1), "b": (7 + i, 1), "c": (5 + i, 1)}])
        for i in range(4)],
    "two_stripes_on_one_block_in_staging_order": [
        (0, [{"a": (0, 5), "b": (2, 3)}, {"a": (5, 2), "b": (5, 4)},
             {"a": (7, 3)}])],
}


def _managers():
    jm = jkv.KVCacheManager(jkv.KVGeometry(**GEOM), 1 << 20,
                            offload_quant="int8")
    tm = tkv.KVCacheManager(tkv.KVGeometry(**GEOM), 1 << 20,
                            offload_quant="int8")
    for m in (jm, tm):
        for rid, cap in CAPS.items():
            m.register(rid, cap, 4)
    return jm, tm


def _assert_same_bytes(jp, tp):
    for a, b in ((jp.k, tp.k), (jp.v, tp.v), (jp.k_scale, tp.k_scale),
                 (jp.v_scale, tp.v_scale)):
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)


def _stripe(r, T, mag):
    return (r.standard_normal((2, T, 16)) * mag).astype(np.float32)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_flush_fused_matches_reference_host_pool(name):
    jm, tm = _managers()
    r = np.random.default_rng(len(name))
    for layer, saves in SCENARIOS[name]:
        for save in saves:
            kv = {rid: (start, _stripe(r, T, r.uniform(0.1, 8.0)),
                        _stripe(r, T, r.uniform(0.1, 8.0)))
                  for rid, (start, T) in save.items()}
            jm.save_new_tokens_fused(layer, kv)
            tm.save_new_tokens_fused(layer, kv)
        rids = list(saves[0])
        want = sum(jm.pools[rid].flush() for rid in rids)
        assert tm.flush_fused(layer, rids) == want > 0
        for rid in CAPS:
            _assert_same_bytes(jm.pools[rid], tm.pools[rid])
            assert not tm.pools[rid]._staging
    assert asdict(tm.total_stats()) == asdict(jm.total_stats())
    assert sum(ops.launches.snapshot().values()) == 0


def test_staging_order_decides_a_shared_block():
    """Two stripes on one block requantize it twice; one merged stripe
    requantizes it once, to other bytes: flush_fused must do the former
    (the reference's order), which the scenario above holds byte for
    byte."""
    r = np.random.default_rng(3)
    small, large = _stripe(r, 5, 1.0), _stripe(r, 2, 3.0)
    out = []
    for parts in (((0, small), (5, large)),
                  ((0, np.concatenate([small, large], axis=1)),)):
        _, tm = _managers()
        for start, k in parts:
            tm.save_new_tokens_fused(0, {"a": (start, k, k)})
        tm.flush_fused(0, ["a"])
        out.append(tm.pools["a"].k[0, :, 0].clone())
    assert not torch.equal(out[0], out[1])


def _filled_pools(r, jp, tp):
    """Both pools hold the same int8 blocks and scales, some blocks fresh
    (scale 0)."""
    for name in ("k", "v"):
        x = (r.standard_normal(getattr(jp, name).shape)
             * r.uniform(0.1, 5.0, (2, 2, jp.num_blocks, 1, 1)))
        x[:, :, -1] = 0.0
        q = np.empty(x.shape, np.int8)
        s = np.empty(x.shape[:3], np.float32)
        for layer in range(2):
            for b in range(jp.num_blocks):
                q[layer, :, b], s[layer, :, b] = jkv._quantize_block_np(
                    x[layer, :, b].astype(np.float32))
        getattr(jp, name)[...] = q
        getattr(jp, f"{name}_scale")[...] = s
        getattr(tp, name).copy_(torch.from_numpy(q))
        getattr(tp, f"{name}_scale").copy_(torch.from_numpy(s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_reference_on_filled_pools(dtype):
    g = GEOM
    jp = jkv.HostPool(jkv.KVGeometry(**g), 6, quant="int8")
    tp = tkv.HostPool(tkv.KVGeometry(**g), 6, quant="int8")
    r = np.random.default_rng(21)
    _filled_pools(r, jp, tp)
    saves = []
    for layer, start, T in ((0, 3, 18), (1, 8, 8), (1, 40, 1), (0, 20, 2)):
        k, v = _stripe(r, T, 6.0), _stripe(r, T, 0.2)
        # the stripe as the card holds it; the reference gets its values
        tk, tv = torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype)
        jp.stage(layer, start, tk.float().numpy(), tv.float().numpy())
        saves += [ops.QuantSave(tp.k_quant, layer, start, tk),
                  ops.QuantSave(tp.v_quant, layer, start, tv)]
    written = jp.flush()
    assert ops.quant_save_blocks(saves) == 2 * written
    _assert_same_bytes(jp, tp)


def _cols(start, T, pool=1 << 20, scale=1 << 30, stripe=1 << 40, NB=6,
          hs=7, ts=3, esz=4, code=0):
    return (stripe, hs, ts, esz, pool, NB, scale, code, start, T)


@pytest.mark.parametrize("case", ["mid_block_three_blocks", "whole_blocks",
                                  "repeated_blocks"])
def test_pack_save_items(case):
    bs, D = 8, 16
    if case == "mid_block_three_blocks":
        items, sizes = ops.pack_save_items([_cols(5, 14)], bs, D)
        assert sizes == [3]
        off, n = items[:, 7] & 0xffff, items[:, 7] >> 16 & 0xffff
        assert off.tolist() == [5, 0, 0] and n.tolist() == [3, 8, 3]
        # the stripe's tokens 0, 3 and 11 open the segments
        assert (items[:, 0] - (1 << 40)).tolist() == [0, 3 * 3 * 4,
                                                      11 * 3 * 4]
        assert (items[:, 3] - (1 << 20)).tolist() == [0, bs * D, 2 * bs * D]
        assert (items[:, 5] - (1 << 30)).tolist() == [0, 4, 8]
        assert items[:, 4].tolist() == [6 * bs * D] * 3
        assert items[:, [1, 2, 6]].tolist() == [[7, 3, 6]] * 3
    elif case == "whole_blocks":
        items, sizes = ops.pack_save_items(
            [_cols(16, 16, code=1, esz=2), _cols(0, 8, pool=1 << 22)],
            bs, D)
        assert sizes == [3]
        assert (items[:, 7] & 0xffff).tolist() == [0, 0, 0]
        assert (items[:, 7] >> 16 & 0xffff).tolist() == [8, 8, 8]
        assert (items[:, 7] >> 32).tolist() == [1, 1, 0]
    else:
        # block 0 of pool A three times, block 1 once, block 0 of pool B
        # once: three rounds, each block's segments in staging order
        cols = [_cols(0, 5, stripe=100), _cols(0, 4, pool=1 << 24,
                                                stripe=200),
                _cols(5, 2, stripe=300), _cols(7, 3, stripe=400)]
        items, sizes = ops.pack_save_items(cols, bs, D)
        assert sizes == [3, 1, 1]
        assert items[:, 0].tolist() == [100, 200, 400 + 1 * 3 * 4, 300,
                                        400]
        for lo, hi in ((0, 3), (3, 4), (4, 5)):
            dest = items[lo:hi, 3].tolist()
            assert len(set(dest)) == len(dest)


@pytest.mark.parametrize("bad", ["block_past_the_pool", "negative_start",
                                 "layer_out_of_range"])
def test_quant_save_refusals_write_nothing(bad):
    tp = tkv.HostPool(tkv.KVGeometry(**GEOM), 3, quant="int8")
    before = [t.clone() for t in (tp.k, tp.k_scale)]
    good = ops.QuantSave(tp.k_quant, 0, 0, torch.ones((2, 4, 16)))
    layer, start = {"block_past_the_pool": (1, 22),
                    "negative_start": (0, -1),
                    "layer_out_of_range": (2, 0)}[bad]
    with pytest.raises(IndexError):
        ops.quant_save_blocks([good, good._replace(layer=layer,
                                                   start=start)])
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 (tp.k, tp.k_scale)))


def test_quant_save_refuses_stripes_off_the_card():
    """A stripe on a device that is neither the CPU nor CUDA, beside CPU
    pools, is a mix the wrapper does not take."""
    tp = tkv.HostPool(tkv.KVGeometry(**GEOM), 3, quant="int8")
    stripe = torch.empty((2, 4, 16), device="meta")
    with pytest.raises(ValueError):
        ops.quant_save_blocks([ops.QuantSave(tp.k_quant, 0, 0, stripe)])
