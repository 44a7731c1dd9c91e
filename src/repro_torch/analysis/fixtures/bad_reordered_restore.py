"""Planted violation: the fused restore lands AFTER the attend launch
that needs those blocks resident (restore-before-use).  Analyzed as
source only; never imported."""
from repro_torch.models import model as M


class BadPlane:
    def step_staged(self, params, cfg, tokens, kv_mgr):
        st = self.state
        x = M.decode_embed(params, cfg, tokens)
        for i in range(cfg.num_layers):
            q, _, idx, valid = M.decode_select_layer(
                params, cfg, x, st["caches"][i], st["cur_len"])
            sel = idx.cpu().numpy()
            kv_mgr.save_new_tokens_fused(i, self.stripes(i))
            missing, _ = kv_mgr.access_layer(i, self.blocks(sel))
            payloads = kv_mgr.load_blocks_fused(i, missing)
            x = M.decode_attend_layer(params, cfg, x, q, st["caches"][i],
                                      st["cur_len"], idx, valid, None)
            self.restore_blocks_fused(i, payloads, before_use=True)  # late
        return M.decode_logits(params, cfg, x, st["cur_len"], None)
