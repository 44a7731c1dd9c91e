"""Planted violation: a stage launch inside a loop over requests (the
O(L) launch budget becomes O(L * batch): launches-per-iteration).
Analyzed as source only; never imported."""
from repro_torch.models import model as M


class BadGroup:
    def _run_group(self, params, cfg, layer, start, rids):
        outs = []
        for rid in rids:                          # one launch per request
            outs.append(M.prefill_attn_layer_batched(
                M.get_layer(params, layer), cfg, self.window(rid, start),
                self.positions(rid), None, None))
        return outs
