"""Planted violation: two FlashD2H saves in one (layer, group) window
(fused-transfer: one fused save per window).  Analyzed as source only;
never imported."""
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
            kv_mgr.save_new_tokens_fused(i, self.stripes(i))   # second save
            missing, _ = kv_mgr.access_layer(i, blocks)
            payloads = kv_mgr.load_blocks_fused(i, missing)
            self.restore_blocks_fused(i, payloads, before_use=True)
            x = M.decode_attend_layer(params, cfg, x, q, st["caches"][i],
                                      st["cur_len"], idx, valid, None)
        return M.decode_logits(params, cfg, x, st["cur_len"], None)
