"""Planted-violation fixtures of the port's plane-contract analyzer.

Each fixture is a mini-plane in the port's idiom carrying EXACTLY ONE
violation of one stage-protocol rule (``clean_mini`` carries none).
``FIXTURES`` maps name -> (AnalysisTarget, expected rule); the files are
analyzed as source only and never imported."""
from __future__ import annotations

from repro_torch.core import plane_contract as pc

_FX = "src/repro_torch/analysis/fixtures"
_ASYNC = (("worker is not None", True),)


def _target(name: str, qualname: str, protocol: str, callback: str = "",
            cb_qualname: str = "", batch=(), assume=()) -> pc.AnalysisTarget:
    callbacks = ((pc.CallbackSpec(callback, f"{_FX}/{name}.py",
                                  cb_qualname),) if callback else ())
    return pc.AnalysisTarget(name=name, drivers=(pc.DriverSpec(
        name=name, file=f"{_FX}/{name}.py", qualname=qualname,
        protocol=protocol, callbacks=callbacks, batch_iterables=batch,
        assume=assume),))


FIXTURES = {
    "bad_reordered_restore": (
        _target("bad_reordered_restore", "BadPlane.step_staged",
                "staged-decode"),
        pc.RULE_RESTORE_BEFORE_USE),
    "bad_drop_before_writeback": (
        _target("bad_drop_before_writeback", "BadPlane.step_staged",
                "staged-decode"),
        pc.RULE_WRITEBACK_BEFORE_DROP),
    "bad_double_d2h": (
        _target("bad_double_d2h", "BadPlane.step_staged", "staged-decode"),
        pc.RULE_FUSED_TRANSFER),
    "bad_quant_double_restore": (
        _target("bad_quant_double_restore", "BadPlane.step_staged",
                "staged-decode"),
        pc.RULE_FUSED_TRANSFER),
    "bad_mixed_double_stage": (
        _target("bad_mixed_double_stage", "BadHybrid.run_iteration",
                "hybrid-plane", "layer_cb", "mixed_layer_cb"),
        pc.RULE_FUSED_TRANSFER),
    "bad_ctx_after_window": (
        _target("bad_ctx_after_window", "BadPrefill.run_iteration",
                "prefill-plane", "group_cb", "good_group_cb"),
        pc.RULE_CTX_LIFETIME),
    "bad_sync_in_window": (
        _target("bad_sync_in_window", "BadAsyncPlane.step_staged",
                "staged-decode-async", "stage_cb", "stage_cb",
                assume=_ASYNC),
        pc.RULE_NO_SYNC_IN_DISPATCH_WINDOW),
    "bad_per_request_launch": (
        _target("bad_per_request_launch", "BadGroup._run_group",
                "prefill-group", batch=("rids",)),
        pc.RULE_LAUNCHES),
    "clean_mini": (
        _target("clean_mini", "GoodPlane.step_staged", "staged-decode-async",
                "stage_cb", "stage_cb", batch=("token_by_req",),
                assume=_ASYNC),
        None),
}
