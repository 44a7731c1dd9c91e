"""Persistent shared device decode pool — the engine's decode data plane.

Counterpart of the staged plane of ``repro/core/device_pool.py``.  One
padded paged pool per layer lives on the device for the lifetime of the
decode batch: a request is admitted once into a free batch row
(``admit``), nothing is copied per iteration while it decodes, and
``release`` frees the row for the next request (lowest row first, so a
replayed trace is deterministic).  Pool capacity follows
``BucketingPolicy`` buckets.  Requests scheduled this iteration are picked
with a step mask, so occupancy changes never change shapes.

The reference updates functional pool values through jitted stages; here
every write is IN PLACE on the plane's tensors: the select stage's append
and metadata update, the FlashH2D restores (``restore_blocks_fused``,
through the ``scatter_blocks_hkv`` kernel on the GPU) and the eviction
drops (``drop_blocks``, which scatters zero blocks through the same
kernel).  Stage functions are plain calls of ``models/model.py``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import HostCopy, host_to_device
from repro_torch.kernels import ops
from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class BucketingPolicy:
    """Shape-bucketing policy of the decode and prefill planes (a copy of
    the reference's).

    batch_buckets: allowed padded batch-row counts; demand beyond the last
        bucket doubles it (8 -> 16 -> 32 ...).
    block_bucket: pool block capacity is rounded UP to a multiple of this.
    token_bucket: prefill-plane token-length grid — windows round up to
        token_bucket, then DOUBLE (64, 128, 256, ...).
    """
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    block_bucket: int = 8
    token_bucket: int = 64

    def bucket_batch(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        b = self.batch_buckets[-1]
        while b < n:
            b *= 2
        return b

    def bucket_blocks(self, nb: int) -> int:
        bb = self.block_bucket
        return max(bb, -(-nb // bb) * bb)

    def bucket_tokens(self, n: int) -> int:
        t = self.token_bucket
        while t < n:
            t *= 2
        return t


def gather_row_blocks(pool: torch.Tensor, row: int, blocks
                      ) -> torch.Tensor:
    """Gather ``blocks`` of one batch row: (B,H,NB,bs,D) -> (H,K,bs,D),
    through the ``gather_blocks_hkv`` kernel on the GPU."""
    idx = host_to_device(blocks, pool.device)
    return ops.gather_blocks_hkv(pool[row], idx)


def scatter_row_blocks(pool: torch.Tensor, row: int, blocks,
                       payload: torch.Tensor) -> torch.Tensor:
    """Scatter ``payload`` (H,K,bs,D) into ``blocks`` of one batch row IN
    PLACE (whole blocks, untouched blocks preserved), through the
    ``scatter_blocks_hkv`` kernel on the GPU.  Returns ``pool``."""
    idx = host_to_device(blocks, pool.device)
    ops.scatter_blocks_hkv(pool[row], payload, idx)
    return pool


class DevicePoolPlane:
    """Persistent padded decode state for one group of batched requests.

    The plane OWNS its requests' decode state after ``admit``."""

    def __init__(self, cfg, policy: Optional[BucketingPolicy] = None):
        self.cfg = cfg
        self.policy = policy or BucketingPolicy()
        self.state: Optional[Dict] = None
        self.b_cap = 0
        self.nb_cap = 0
        self.rows: Dict[str, int] = {}            # req_id -> batch row
        self.cur_host: Dict[str, int] = {}        # host mirror of cur_len
        self._free: List[int] = []                # sorted free rows
        self.steps = 0
        self.blocks_dropped = 0
        self.blocks_restored = 0
        self.blocks_restored_before_use = 0
        self.host_syncs = 0              # per-layer selected-id syncs
        self.d2h_readback_bytes = 0      # stripe bytes read back

    @property
    def device(self) -> torch.device:
        return self.state["cur_len"].device

    # -- capacity ----------------------------------------------------------

    def _alloc(self, template: Dict, b_cap: int, nb_cap: int) -> Dict:
        caches = []
        for c in template["caches"]:
            caches.append({
                key: v.new_zeros((b_cap,) + v.shape[1:2] + (nb_cap,)
                                 + v.shape[3:])
                for key, v in c.items()})
        dev = template["caches"][0]["k"].device
        return {"caches": caches,
                "cur_len": torch.zeros((b_cap,), dtype=torch.int32,
                                       device=dev),
                "extra": {}}

    def _grow(self, b_cap: int, nb_cap: int) -> None:
        st = self.state
        for c in st["caches"]:
            for key, v in c.items():
                new = v.new_zeros((b_cap,) + v.shape[1:2] + (nb_cap,)
                                  + v.shape[3:])
                new[:self.b_cap, :, :self.nb_cap] = v
                c[key] = new
        cl = st["cur_len"].new_zeros((b_cap,))
        cl[:self.b_cap] = st["cur_len"]
        st["cur_len"] = cl
        for r in range(self.b_cap, b_cap):
            bisect.insort(self._free, r)

    def _ensure_capacity(self, template: Dict, need_rows: int,
                         need_nb: int) -> None:
        b_cap = max(self.b_cap, self.policy.bucket_batch(need_rows))
        nb_cap = max(self.nb_cap, self.policy.bucket_blocks(need_nb))
        if self.state is None:
            self.state = self._alloc(template, b_cap, nb_cap)
            self._free = list(range(b_cap))
        elif b_cap != self.b_cap or nb_cap != self.nb_cap:
            self._grow(b_cap, nb_cap)
        self.b_cap, self.nb_cap = b_cap, nb_cap

    # -- slot lifecycle ----------------------------------------------------

    def admit(self, req_id: str, state: Dict) -> int:
        """Copy one request's DecodeState (B=1 list-mode pools;
        ``cur_len`` a host tensor) into a free batch row; returns the row.
        The only full-pool copy in a request's decode lifetime."""
        if req_id in self.rows:
            raise ValueError(f"{req_id} already admitted")
        if int(state["cur_len"].shape[0]) != 1:
            raise ValueError("admit expects a single-request state (B=1)")
        nbs = [c["k"].shape[2] for c in state["caches"]]
        self._ensure_capacity(state, len(self.rows) + 1, max(nbs))
        row = self._free.pop(0)
        st = self.state
        for l, c in enumerate(state["caches"]):
            for key, v in c.items():
                st["caches"][l][key][row, :, :nbs[l]] = v[0]
        cur = int(state["cur_len"][0])
        st["cur_len"][row] = cur
        self.rows[req_id] = row
        self.cur_host[req_id] = cur
        return row

    def release(self, req_id: str) -> int:
        """Free a finished request's row for reuse."""
        row = self.rows.pop(req_id)
        self.cur_host.pop(req_id)
        bisect.insort(self._free, row)
        return row

    def batch_inputs(self, token_by_req: Dict[str, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens (B_cap,) int32, step mask (B_cap,) bool) on the device:
        scheduled rows carry their input token, every other row is
        parked."""
        tokens = np.zeros((self.b_cap,), np.int32)
        mask = np.zeros((self.b_cap,), bool)
        for rid, tok in token_by_req.items():
            tokens[self.rows[rid]] = tok
            mask[self.rows[rid]] = True
        return (host_to_device(tokens, self.device),
                host_to_device(mask, self.device, torch.bool))

    # -- iteration ---------------------------------------------------------

    def step_staged(self, params: Dict, token_by_req: Dict[str, int],
                    stage_cb=None) -> Tuple[torch.Tensor, Dict,
                                            Dict[str, int]]:
        """Staged per-layer pipeline over every layer: select ->
        ``stage_cb(layer, sel_np, prev_lens)`` on the host -> attend, so
        restores land before the attention that selected them.  The copy
        of the selected ids to the host is the one device sync per layer.
        Returns (logits (B_cap, V), info, {req_id: cur_len before})."""
        cfg = self.cfg
        tokens, mask = self.batch_inputs(token_by_req)
        st = self.state
        prev = {rid: self.cur_host[rid] for rid in token_by_req}
        info: Dict[str, Any] = {"selected": {}}
        x = M.decode_embed(params, cfg, tokens)
        for i in range(cfg.num_layers):
            p = M.get_layer(params, i)
            q, _, idx, valid = M.decode_select_layer(
                p, cfg, x, st["caches"][i], st["cur_len"], step_mask=mask)
            if idx is not None:
                info["selected"][i] = idx
            if stage_cb is not None:
                sel = None if idx is None else idx.cpu().numpy()
                if sel is not None:
                    self.host_syncs += 1
                stage_cb(i, sel, prev)
            x = M.decode_attend_layer(p, cfg, x, q, st["caches"][i],
                                      st["cur_len"], idx, valid)
        logits, st["cur_len"] = M.decode_logits(params, cfg, x,
                                                st["cur_len"], mask)
        self.finish_step(token_by_req)
        return logits, info, prev

    def finish_step(self, token_by_req: Dict[str, int]) -> None:
        self.steps += 1
        for rid in token_by_req:
            self.cur_host[rid] += 1

    # -- data plane: FlashH2D/D2H wiring ----------------------------------

    def pool_layers(self) -> List[int]:
        """Model-layer indices that hold paged attention pools."""
        if self.state is None:
            return []
        return list(range(len(self.state["caches"])))

    def new_token_kv(self, req_ids: List[str], prev_lens: Dict[str, int],
                     layers: Optional[List[int]] = None
                     ) -> Dict[int, Tuple[np.ndarray, Optional[np.ndarray]]]:
        """The KV stripe this iteration appended, as host float32 arrays:
        {model_layer: (k (R,Hkv,D), v (R,Hkv,D))}, rows ordered like
        ``req_ids``."""
        return {l: tuple(pending.wait()) for l, pending in
                self.new_token_kv_async(req_ids, prev_lens, layers).items()}

    def new_token_kv_async(self, req_ids: List[str],
                           prev_lens: Dict[str, int],
                           layers: Optional[List[int]] = None
                           ) -> Dict[int, HostCopy]:
        """Launch the appended-KV stripe gathers and their copies to pinned
        host memory WITHOUT a host sync; each value's ``wait()`` gives what
        ``new_token_kv`` returns.  The gather makes a new tensor right after
        the layer's select, so later in-place pool writes (restores, drops,
        the next select) cannot reach the stripe."""
        bs = self.cfg.dsa.block_size
        dev = self.device
        pos = np.asarray([prev_lens[r] for r in req_ids], np.int64)
        rows = host_to_device([self.rows[r] for r in req_ids], dev,
                              torch.int64)
        blk = host_to_device(pos // bs, dev, torch.int64)
        slot = host_to_device(pos % bs, dev, torch.int64)
        out: Dict[int, HostCopy] = {}
        for l in (self.pool_layers() if layers is None else layers):
            c = self.state["caches"][l]
            k = c["k"][rows, :, blk, slot].float()          # (R, Hkv, D)
            v = c["v"][rows, :, blk, slot].float()
            self.d2h_readback_bytes += (k.numel() + v.numel()) * 4
            out[l] = HostCopy(k, v)
        return out

    def restore_blocks_fused(self, layer: int,
                             payload_by_req: Dict[str, Tuple[List[int],
                                                             torch.Tensor,
                                                             Any]],
                             before_use: bool = False) -> None:
        """Land one layer's fused FlashH2D payloads for the WHOLE batch
        with one ``scatter_blocks_hkv`` launch per tensor, IN PLACE.
        payload_by_req: {req_id: (blocks, k (Hkv,K,bs,D), v)}; the payloads
        are cast to the pool dtype by the kernel.  before_use: the restore
        lands between the layer's select and attend stages."""
        c = self.state["caches"][layer]
        rows_l: List[int] = []
        blks_l: List[int] = []
        ks, vs = [], []
        for req_id, (blocks, k_pay, v_pay) in payload_by_req.items():
            rows_l.extend([self.rows[req_id]] * len(blocks))
            blks_l.extend(blocks)
            ks.append(k_pay)
            vs.append(v_pay)
        if not blks_l:
            return
        dev = self.device
        rows = host_to_device(rows_l, dev)
        blks = host_to_device(blks_l, dev)
        ops.scatter_blocks_hkv(c["k"], torch.cat(ks, dim=1), blks, rows)
        ops.scatter_blocks_hkv(c["v"], torch.cat(vs, dim=1), blks, rows)
        self.blocks_restored += len(blks_l)
        if before_use:
            self.blocks_restored_before_use += len(blks_l)

    def drop_blocks(self, req_id: str, layer: int,
                    blocks: List[int]) -> None:
        """Zero evicted blocks' device data IN PLACE by scattering zero
        blocks (HBM eviction really drops device data).  Block METADATA
        stays, so DSA scoring is exact; re-selected blocks come back
        through ``restore_blocks_fused``."""
        row = self.rows[req_id]
        c = self.state["caches"][layer]
        H, _, bs, D = c["k"].shape[1:]
        zero = c["k"].new_zeros((H, len(blocks), bs, D))
        scatter_row_blocks(c["k"], row, blocks, zero)
        scatter_row_blocks(c["v"], row, blocks, zero)
        self.blocks_dropped += len(blocks)
