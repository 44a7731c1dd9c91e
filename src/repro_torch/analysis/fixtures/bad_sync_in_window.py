"""Planted violation: a host-blocking sync inside an ASYNC dispatch
window.  The callback serves both modes in one body, as the engine's do:
its sync branch (``worker is None``) reads the stripe back with the
blocking ``new_token_kv``, which the sync oracle may; its async branch
reads a count off the device with ``.item()``, which stalls the dispatch
thread until the queued attend and select have run, the overlap the
async mode exists to keep (no-sync-in-dispatch-window).  Only the async
branch is read under the async protocol.  Analyzed as source only; never
imported."""
from repro_torch.models import model as M


def stage_cb(plane, kv_mgr, worker, layer, sel, prev, mask, ship):
    if worker is not None:
        rows = int(mask.sum().item())         # BAD: a device sync
        pending = plane.new_token_kv_async(plane.req_ids[:rows], prev,
                                           [layer], ship)[layer]
        worker.submit(layer, plane.save, pending)
    else:
        kv = plane.new_token_kv(plane.req_ids, prev, [layer], ship)[layer]
        kv_mgr.save_new_tokens_fused(layer, kv)
    missing, _ = kv_mgr.access_layer(layer, plane.blocks(sel))
    if missing:
        if worker is not None:
            worker.fence(layer)
        payloads = kv_mgr.load_blocks_fused(layer, missing)
        plane.restore_blocks_fused(layer, payloads, before_use=True)


class BadAsyncPlane:
    def step_staged(self, params, cfg, tokens, stage_cb):
        st = self.state
        x = M.decode_embed(params, cfg, tokens)
        for i in range(cfg.num_layers):
            q, _, idx, valid = M.decode_select_layer(
                params, cfg, x, st["caches"][i], st["cur_len"])
            stage_cb(i, idx.cpu().numpy(), self.prev)
            x = M.decode_attend_layer(params, cfg, x, q, st["caches"][i],
                                      st["cur_len"], idx, valid, None)
        return M.decode_logits(params, cfg, x, st["cur_len"], None)
