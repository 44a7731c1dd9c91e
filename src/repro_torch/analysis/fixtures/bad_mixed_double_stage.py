"""Planted violation: a SECOND per-layer host stage in a mixed iteration.
The hybrid-plane protocol merges the decode write-back and the layer's
fresh prefill KV into ONE FlashD2H save (and at most one FlashH2D load
and restore) per layer window; running the host stage twice doubles
every transfer (fused-transfer).  Analyzed as source only; never
imported."""
from repro_torch.models import model as M


def mixed_layer_cb(win, kv_mgr, plane):
    # the one per-layer host stage: merged save, merged load, restore
    kv_mgr.save_new_tokens_fused(win.layer, win.stripes)
    payloads = kv_mgr.load_blocks_fused(win.layer, win.missing)
    plane.restore_blocks_fused(win.layer, payloads, before_use=True)


class BadHybrid:
    def run_iteration(self, params, cfg, dec, layer_cb):
        for d in dec:
            d.x = M.decode_embed(params, cfg, d.tokens)
        for i in range(cfg.num_layers):
            for d in dec:
                d.q, _, d.idx, d.valid = M.decode_select_layer(
                    params, cfg, d.x, d.caches[i], d.cur_len)
            win = self.window(i, dec)
            layer_cb(win)
            layer_cb(win)               # second host stage, same layer
            for d in dec:
                d.x = M.decode_attend_layer(params, cfg, d.x, d.q,
                                            d.caches[i], d.cur_len, d.idx,
                                            d.valid, None)
        return [M.decode_logits(params, cfg, d.x, d.cur_len, None)
                for d in dec]
