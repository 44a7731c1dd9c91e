"""Planted violation: the one-layer prefill context is read OUTSIDE the
group callback, after the next group's launch may have overwritten it
(ctx-lifetime).  The callback itself is well-formed: context read, one
fused FlashD2H, its flush, then the HBM layer evict.  Analyzed as source
only; never imported."""


def good_group_cb(g, plane, kv_mgr, cache, ship):
    kv = plane.read_group_kv(g, ship)
    kv_mgr.save_new_tokens_fused(g.layer, kv)
    kv_mgr.flush_fused(g.layer, list(g.req_ids))
    cache.drop_layer(g.layer)


class BadPrefill:
    def run_iteration(self, params, allowance, group_cb):
        walk = self.begin_iteration(allowance)
        while True:
            pending = self._pending(walk)
            if not pending:
                break
            for layer, start in sorted(pending):
                g = self._launch(params, layer, start, pending[(layer, start)],
                                 walk)
                group_cb(g)
                self.stale.append(self.layer_ctx(g.req_ids[0]))   # recycled
        return self.finish_iteration(params, walk)
