"""The decode plane's eviction drops, batched: a whole round of (request,
layer, blocks) zeroed at once (``DevicePoolPlane.drop_blocks_many``,
``ops.zero_blocks_hkv`` and its plain version ``ref.zero_blocks_hkv``)
against the reference plane's ``drop_blocks`` applied once per (request,
layer), on the same pools made by numpy from a seed.  Pools are compared
exactly (zeroing is exact), and so is ``blocks_dropped``.  The ids of a
drop or a scatter are range-checked on the host: one out of range raises
IndexError and writes nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.device_pool import DevicePoolPlane as JPlane
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.device_pool import DevicePoolPlane as TPlane
from repro_torch.kernels import ops, ref

LAYERS, H, BS, D = 3, 2, 4, 16
NBS = {"a": 7, "b": 5, "c": 9}          # per request: blocks in its pools
# one eviction round: {(request, layer): blocks}, repeats across requests
# and layers, one block listed twice
ROUND = {("a", 0): [0, 3, 6], ("b", 0): [3], ("c", 2): [8, 1, 1],
         ("a", 2): [2], ("b", 1): [0, 4], ("c", 0): [5]}


def _states(seed):
    r = np.random.default_rng(seed)
    out = {}
    for rid, nb in NBS.items():
        caches = [{"k": r.standard_normal((1, H, nb, BS, D), np.float32),
                   "v": r.standard_normal((1, H, nb, BS, D), np.float32),
                   "meta": r.standard_normal((1, H, nb, 2, D), np.float32)}
                  for _ in range(LAYERS)]
        out[rid] = (caches, nb * BS - 1)
    return out


def _jax_plane(states):
    plane = JPlane(jax_smoke("qwen2-0.5b"))
    for rid, (caches, cur) in states.items():
        plane.admit(rid, {
            "caches": [{k: jnp.asarray(v) for k, v in c.items()}
                       for c in caches],
            "cur_len": jnp.asarray([cur], jnp.int32), "extra": {}})
    return plane


def _torch_plane(states):
    plane = TPlane(torch_smoke("qwen2-0.5b"))
    for rid, (caches, cur) in states.items():
        plane.admit(rid, {
            "caches": [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
                       for c in caches],
            "cur_len": torch.tensor([cur], dtype=torch.int32), "extra": {}})
    return plane


def _pools_np(plane):
    return [np.asarray(c[key]) for c in plane.state["caches"]
            for key in ("k", "v")]


def _items(plane, round_):
    """The round as zero_blocks_hkv items: pool 2 * layer (K) and
    2 * layer + 1 (V) of the request's row, every block."""
    which, rows, blocks = [], [], []
    for (rid, layer), blks in round_.items():
        for pool in (2 * layer, 2 * layer + 1):
            which += [pool] * len(blks)
            rows += [plane.rows[rid]] * len(blks)
            blocks += blks
    return which, rows, blocks


@pytest.mark.parametrize("seed", [0, 1])
def test_zero_round_matches_reference_drops_per_item(seed):
    """ref.zero_blocks_hkv (and ops.zero_blocks_hkv on the CPU) over the
    round's items give the pools of the reference's per-(request, layer)
    drop_blocks, exactly; untouched blocks keep their data."""
    states = _states(seed)
    jplane = _jax_plane(states)
    before = _pools_np(jplane)
    for (rid, layer), blks in ROUND.items():
        jplane.drop_blocks(rid, layer, blks)
    want = _pools_np(jplane)
    items = _items(jplane, ROUND)
    for zero in (lambda p: ref.zero_blocks_hkv(
                     p, *(torch.tensor(a) for a in items)),
                 lambda p: ops.zero_blocks_hkv(p, *items)):
        pools = [torch.from_numpy(a.copy()) for a in before]
        zero(pools)
        for got, w in zip(pools, want):
            np.testing.assert_array_equal(got.numpy(), w)
    assert sum(int((w != b).any(axis=(1, 3, 4)).sum())
               for w, b in zip(want, before)) == 2 * len(
        {(k, b) for k, blks in ROUND.items() for b in blks})


def test_drop_blocks_many_equals_per_call_path():
    """One drop_blocks_many of the round leaves the pools and
    blocks_dropped of one drop_blocks call per (request, layer), in the
    port and in the reference."""
    states = _states(2)
    per_call, batched = _torch_plane(states), _torch_plane(states)
    jplane = _jax_plane(states)
    for (rid, layer), blks in ROUND.items():
        per_call.drop_blocks(rid, layer, blks)
        jplane.drop_blocks(rid, layer, blks)
    ops.launches.reset()
    batched.drop_blocks_many(ROUND)
    assert sum(ops.launches.counts.values()) == 0     # the plain version
    assert batched.blocks_dropped == per_call.blocks_dropped \
        == jplane.blocks_dropped == sum(len(b) for b in ROUND.values())
    for got, want, ref_np in zip(_pools_np(batched), _pools_np(per_call),
                                 _pools_np(jplane)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref_np)
    batched.drop_blocks_many({})                      # an empty round
    assert batched.blocks_dropped == per_call.blocks_dropped


def test_plane_pool_table_follows_growth():
    """The table of K and V pools is rebuilt when the plane grows, so a
    drop after growth lands in the new pools."""
    states = _states(3)
    plane = _torch_plane({"a": states["a"]})
    first = plane.pool_table
    assert len(first) == 2 * LAYERS
    plane.admit("c", {"caches": [{k: torch.from_numpy(v.copy())
                                  for k, v in c.items()}
                                 for c in states["c"][0]],
                      "cur_len": torch.tensor([3], dtype=torch.int32),
                      "extra": {}})
    assert plane.pool_table is not first
    assert all(p is c[key] for p, (c, key) in zip(
        plane.pool_table.pools,
        [(c, key) for c in plane.state["caches"] for key in ("k", "v")]))
    plane.drop_blocks("c", 1, [8])
    assert not plane.state["caches"][1]["k"][plane.rows["c"], :, 8].any()
    assert plane.state["caches"][1]["k"][plane.rows["c"], :, 7].any()


# ---------------------------------------------------------------------------
# device dispatch and id checks
# ---------------------------------------------------------------------------

def _pools(n=4, B=2, NB=6):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((B, H, NB, BS, D), generator=g).to(torch.bfloat16)
            for _ in range(n)]


def test_zero_blocks_takes_plain_version_only_when_all_on_cpu():
    pools = _pools()
    ops.launches.reset()
    out = ops.zero_blocks_hkv(pools, [0, 3], [1, 0], [5, 2])
    assert all(p.device.type == "cpu" for p in out)
    assert not pools[0][1, :, 5].any() and not pools[3][0, :, 2].any()
    with pytest.raises(ValueError):                   # pools off the CPU
        ops.zero_blocks_hkv([p.to("meta") for p in pools], [0], [0], [0])
    with pytest.raises(ValueError):                   # a mix of devices
        ops.zero_blocks_hkv([pools[0], pools[1].to("meta")], [0], [0], [0])
    with pytest.raises(ValueError):                   # ids not host-held
        ops.zero_blocks_hkv(pools, torch.tensor([0], device="meta"), [0],
                            [0])
    with pytest.raises(ValueError):                   # strides differ
        ops.zero_blocks_hkv([pools[0], pools[1].transpose(0, 1)], [0], [0],
                            [0])
    assert sum(ops.launches.counts.values()) == 0


@pytest.mark.parametrize("which,rows,blocks", [
    ([0, 4], [0, 0], [1, 1]),          # pool index = table length
    ([1], [2], [0]),                   # row = B
    ([2, 2], [1, 1], [0, 6]),          # block = NB
    ([3], [0], [-1]),                  # negative: would wrap in PyTorch
])
def test_zero_blocks_raises_on_an_id_out_of_range(which, rows, blocks):
    pools = _pools()
    before = [p.clone() for p in pools]
    with pytest.raises(IndexError):
        ops.zero_blocks_hkv(pools, which, rows, blocks)
    assert all(torch.equal(p, b) for p, b in zip(pools, before))


@pytest.mark.parametrize("dest,rows", [([1, 6], None), ([-1], None),
                                       ([0, 2], [0, 2]), ([3], [-1])])
def test_scatter_raises_on_a_host_id_out_of_range(dest, rows):
    """Host-held ids of the scatter are checked before anything is written:
    a block id past NB or negative, a row past B or negative."""
    pool = torch.zeros((2, H, 6, BS, D)) if rows is not None else \
        torch.zeros((H, 6, BS, D))
    payload = torch.ones((H, len(dest), BS, D))
    with pytest.raises(IndexError):
        ops.scatter_blocks_hkv(pool, payload, dest, rows)
    assert not pool.any()


def test_scatter_takes_host_lists_like_tensors():
    g = torch.Generator().manual_seed(1)
    pool = torch.randn((3, H, 6, BS, D), generator=g)
    payload = torch.randn((H, 3, BS, D), generator=g)
    a, b = pool.clone(), pool.clone()
    ops.scatter_blocks_hkv(a, payload, [5, 0, 2], [2, 0, 2])
    ops.scatter_blocks_hkv(b, payload, torch.tensor([5, 0, 2],
                                                    dtype=torch.int32),
                           torch.tensor([2, 0, 2], dtype=torch.int32))
    assert torch.equal(a, b)
    assert torch.equal(a[2, :, 5], payload[:, 0])
