"""A violation-free mini-plane: the staged decode protocol to the letter,
with an async callback that only launches copies and hands them to the
host stage worker.  The analyzer must return zero findings here.
Analyzed as source only; never imported."""
from repro_torch.models import model as M


def stage_cb(engine, plane, kv_mgr, worker, layer, sel, prev, req_ids,
             pending, ship):
    kv = plane.new_token_kv_async(req_ids, prev, [layer], ship)[layer]
    engine._stage_writeback(worker, layer, [(req_ids, prev, kv)], [])
    blocks = plane.blocks(sel)
    missing, _ = kv_mgr.access_layer(layer, blocks)
    if missing:
        worker.fence(layer)
        payloads = kv_mgr.load_blocks_fused(layer, missing)
        plane.restore_blocks_fused(layer, payloads, before_use=True)
    plane._drop_pending_evictions(plane, req_ids, pending,
                                  protect=(layer, blocks))


class GoodPlane:
    def step_staged(self, params, cfg, tokens, token_by_req, stage_cb):
        st = self.state
        x = M.decode_embed(params, cfg, tokens)
        for i in range(cfg.num_layers):
            q, _, idx, valid = M.decode_select_layer(
                params, cfg, x, st["caches"][i], st["cur_len"])
            stage_cb(i, idx.cpu().numpy(), self.prev)
            x = M.decode_attend_layer(params, cfg, x, q, st["caches"][i],
                                      st["cur_len"], idx, valid, None)
        for rid in token_by_req:
            self.cur_host[rid] += 1
        return M.decode_logits(params, cfg, x, st["cur_len"], None)
