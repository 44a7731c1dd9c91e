"""Planted violation: an int8-tier driver that lands its FlashH2D payload
TWICE in one (layer, group) window: once through the fp restore and once
through the fused dequantize-and-scatter (``dequantize_scatter_blocks``,
a restore like ``restore_blocks_fused``).  The save's quant kernels
(``flush_fused``, kind "quant") are part of the one fused save and count
for nothing: only the doubled restore is flagged (fused-transfer).
Analyzed as source only; never imported."""
from repro_torch.kernels import ops
from repro_torch.models import model as M


class BadPlane:
    def step_staged(self, params, cfg, tokens, kv_mgr):
        st = self.state
        x = M.decode_embed(params, cfg, tokens)
        for i in range(cfg.num_layers):
            q, _, idx, valid = M.decode_select_layer(
                params, cfg, x, st["caches"][i], st["cur_len"])
            blocks = self.blocks(idx.cpu().numpy())
            kv_mgr.save_new_tokens_fused(i, self.stripes(i))
            kv_mgr.flush_fused(i, self.req_ids)           # quant, no count
            missing, _ = kv_mgr.access_layer(i, blocks)
            qb = kv_mgr.load_blocks_fused(i, missing)
            self.restore_blocks_fused(i, qb, before_use=True)
            ops.dequantize_scatter_blocks(st["caches"][i]["k"], qb.q,
                                          qb.scales, qb.blks, qb.rows)
            x = M.decode_attend_layer(params, cfg, x, q, st["caches"][i],
                                      st["cur_len"], idx, valid, None)
        return M.decode_logits(params, cfg, x, st["cur_len"], None)
