"""The plane contract of the port: the serving planes' invariants, stated
once, for the static pass (``repro_torch.analysis``) and the runtime
checks (the tests and ``chip_smoke.py``) to read.

Counterpart of ``repro/core/plane_contract.py``, restricted to what has a
counterpart in PyTorch: the six pass-1 (stage-protocol) rules, with the
reference's rule ids, over the port's own call names; the launch and
host-sync budgets; the waiver syntax.  The reference's pass-2 (retrace)
and pass-3 (sharding) rules have none (``NO_COUNTERPART``).

* ``EFFECT_OF_CALL`` classifies every data-plane call a driver may make
  (stage launch / FlashD2H / LRU touch / FlashH2D / restore / drop / pool
  and context readbacks / layer evict / host-blocking sync);
* ``DEFAULT_DRIVERS`` names the stage-loop drivers of the port, the
  engine callbacks spliced into them at their call sites and the engine
  helpers inlined where they are called (``DriverSpec.inlines``), and
  which protocol's rules apply.  The engine's callbacks serve the sync
  oracle and the async dispatch window in ONE body that takes ``worker:
  Optional[HostStageWorker]``; each protocol gets its own driver spec,
  whose ``assume`` fixes that branch (``worker is not None``) wherever an
  ``if`` tests it, so the async rules read the async branch only;
* the budget formulas are the reference's, on the port's ``ModelConfig``,
  and the ``*_mismatch`` helpers hold a run's measured counters against
  them (returning what differs, so the tests and the card's smoke share
  them).

Waivers: an intentional deviation is annotated in-source as

    # plane-contract: allow(<rule>) <reason>

on the offending line or the line directly above it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Rule ids (pass 1 — stage protocol), the reference's strings
# ---------------------------------------------------------------------------

RULE_RESTORE_BEFORE_USE = "restore-before-use"
RULE_WRITEBACK_BEFORE_DROP = "writeback-before-drop"
RULE_FUSED_TRANSFER = "fused-transfer"
RULE_CTX_LIFETIME = "ctx-lifetime"
RULE_LAUNCHES = "launches-per-iteration"
RULE_NO_SYNC_IN_DISPATCH_WINDOW = "no-sync-in-dispatch-window"

ALL_RULES = (
    RULE_RESTORE_BEFORE_USE, RULE_WRITEBACK_BEFORE_DROP,
    RULE_FUSED_TRANSFER, RULE_CTX_LIFETIME, RULE_LAUNCHES,
    RULE_NO_SYNC_IN_DISPATCH_WINDOW,
)

# the reference's pass-2 and pass-3 rules, and why the port has nothing
# for them to check
NO_COUNTERPART: Tuple[Tuple[str, str], ...] = (
    ("traced-branch", "nothing is traced: a stage is an eager call "
                      "(plane.trace_count is 0)"),
    ("tracer-coercion", "nothing is traced: int()/.item() on a tensor is a "
                        "host sync, which no-sync-in-dispatch-window covers"),
    ("np-in-jit", "no jit body exists for numpy to constant-fold into"),
    ("no-obs-in-jit", "no jit body exists: every span is emitted on the "
                      "host around an eager stage call"),
    ("unhashable-key", "no per-shape jit registry keys a config"),
    ("key-missing-field", "no per-shape jit registry caches a stage"),
    ("collective-not-allowed", "no mesh: one device, no collectives"),
    ("sharding-leak", "no mesh: nothing is sharded"),
)

# ---------------------------------------------------------------------------
# Effect vocabulary
# ---------------------------------------------------------------------------

# callee name (the attribute or function a driver calls) -> (kind, sub).
# Kinds as in the reference: "launch" (a stage launch), "d2h" (FlashD2H
# save; sub "fused" or "unfused"), "lru" (residency touch), "h2d" (fused
# FlashH2D gather), "restore" (H2D payloads into device slots), "drop"
# (physical drop of evicted blocks), "pool-read" (the appended KV stripe
# out of a decode pool), "ctx-read" (the one-layer prefill context),
# "layer-evict" (HBM drop of a finished prefill layer), "quant" (the int8
# tier's (re)quantisation, part of its fused transfer, counted by no
# window) and "sync" (a host-blocking wait on the device).
EFFECT_OF_CALL: Dict[str, Tuple[str, str]] = {
    # stage launches of the staged decode plane (models/model.py)
    "decode_embed": ("launch", "embed"),
    "decode_select_layer": ("launch", "select"),
    "decode_attend_layer": ("launch", "attend"),
    "decode_recurrent_layer": ("launch", "recurrent"),
    "decode_logits": ("launch", "logits"),
    # stage launches of the prefill plane
    "prefill_attn_layer_batched": ("launch", "prefill-attn"),
    "prefill_recurrent_layer_batched": ("launch", "prefill-rec"),
    "prefill_logits_batched": ("launch", "finalize"),
    "_run_group": ("launch", "prefill-group"),
    "_launch": ("launch", "prefill-group"),
    # the mixed walk runs a layer's prefill groups / the finalize so
    "run_layer": ("launch", "prefill-group"),
    "finish_iteration": ("launch", "finalize"),
    # the fused, stacked and sequential forwards and the legacy executors
    "decode_step": ("launch", "decode"),
    "prefill_layer": ("launch", "prefill-layer"),
    "layer_forward": ("launch", "layer"),
    "prefill_finalize": ("launch", "finalize"),
    "lm_head": ("launch", "finalize"),
    # FlashD2H
    "save_new_tokens_fused": ("d2h", "fused"),
    "_stage_writeback": ("d2h", "fused"),          # dispatches the merged
    "_stage_writeback_merged": ("d2h", "fused"),   # save (worker or inline)
    "save_contiguous": ("d2h", "unfused"),
    "_save_prompt_layer": ("d2h", "unfused"),      # one request's layer
    # the int8 tier's save kernels are part of the one fused save
    "flush_fused": ("quant", "d2h"),
    "flush": ("quant", "d2h"),
    "quant_save_blocks": ("quant", "d2h"),
    "quantize_blocks": ("quant", "d2h"),
    "dequantize_blocks": ("quant", "h2d"),
    # LRU / FlashH2D / device restore
    "access_layer": ("lru", ""),
    "load_blocks_fused": ("h2d", "fused"),
    "restore_blocks_fused": ("restore", "fused"),
    "dequantize_scatter_blocks": ("restore", "fused"),
    "scatter_row_blocks": ("restore", "unfused"),
    # the decode half of a layer's host stage (LRU round, one fused
    # FlashH2D, its restore): where a driver does not inline it
    "_stage_decode_layer": ("restore", "fused"),
    # eviction
    "drop_blocks": ("drop", "direct"),
    "drop_blocks_many": ("drop", "direct"),
    "zero_blocks_hkv": ("drop", "direct"),
    "_drop_pending_evictions": ("drop", "deferred"),
    "drop_layer": ("layer-evict", ""),
    # readbacks: sub "" = blocking (waits for the copy), "async" = only
    # launches the copy (the HostStageWorker waits for it), "view" = a
    # device view, no transfer
    "new_token_kv": ("pool-read", ""),
    "new_token_kv_async": ("pool-read", "async"),
    "read_group_kv": ("ctx-read", ""),
    "read_group_kv_async": ("ctx-read", "async"),
    "layer_ctx": ("ctx-read", "view"),
    # PyTorch's host-blocking calls: forbidden in an async dispatch window
    "cpu": ("sync", "host"),
    "item": ("sync", "host"),
    "tolist": ("sync", "host"),
    "numpy": ("sync", "host"),
    "synchronize": ("sync", "host"),     # torch.cuda / Stream / Event
    "asarray": ("sync", "host"),         # np.asarray of a tensor
    "wait": ("sync", "host"),            # HostCopy.wait: an event wait
    # blocking obs exports
    "dump_trace": ("sync", "obs"),
    "chrome_trace": ("sync", "obs"),
    "metrics_snapshot": ("sync", "obs"),
    "metrics_prometheus": ("sync", "obs"),
    "prometheus_text": ("sync", "obs"),
}

# ---------------------------------------------------------------------------
# Driver specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CallbackSpec:
    """A function spliced into a driver's stage loop where it is called:
    ``local_name`` is the name the driver calls it by (a callback
    parameter, or a helper method's attribute name); file/qualname locate
    its body."""
    local_name: str
    file: str
    qualname: str


@dataclasses.dataclass(frozen=True)
class DriverSpec:
    """One stage-loop driver the protocol checker linearizes.

    protocol selects the rule set (``PROTOCOL_RULES``); batch_iterables
    are loop-iterable names that range over REQUESTS (a stage launch in
    such a loop breaks the O(L) launch budget); callbacks are spliced at
    calls of their local name, inlines at calls of ``<obj>.<local_name>``;
    assume fixes the value of an ``if`` test (its source text) in the
    driver, its callbacks and its inlines: the branch not taken is not
    linearized."""
    name: str
    file: str
    qualname: str
    protocol: str
    callbacks: Tuple[CallbackSpec, ...] = ()
    inlines: Tuple[CallbackSpec, ...] = ()
    batch_iterables: Tuple[str, ...] = ()
    assume: Tuple[Tuple[str, bool], ...] = ()


PROTOCOL_RULES: Dict[str, Tuple[str, ...]] = {
    # the staged decode window: select -> [cb: d2h, lru, h2d, restore,
    # protected drop] -> attend, per attention layer
    "staged-decode": (RULE_RESTORE_BEFORE_USE, RULE_WRITEBACK_BEFORE_DROP,
                      RULE_FUSED_TRANSFER, RULE_LAUNCHES),
    # the prefill (layer, chunk) group window: launch -> [cb: ctx read,
    # fused d2h, end-of-layer pool build + HBM evict]
    "prefill-plane": (RULE_WRITEBACK_BEFORE_DROP, RULE_FUSED_TRANSFER,
                      RULE_CTX_LIFETIME, RULE_LAUNCHES),
    # the single batched launch that executes one group
    "prefill-group": (RULE_FUSED_TRANSFER, RULE_LAUNCHES),
    # the mixed iteration: the staged-decode window rules and the prefill
    # ctx / write-back rules together
    "hybrid-plane": (RULE_RESTORE_BEFORE_USE, RULE_WRITEBACK_BEFORE_DROP,
                     RULE_FUSED_TRANSFER, RULE_CTX_LIFETIME, RULE_LAUNCHES),
    # the async dispatch windows: the base rules, and nothing in the
    # callback may block on the device (the driver's copy of the selected
    # ids is the one allowed per-layer sync, before the callback runs)
    "staged-decode-async": (RULE_RESTORE_BEFORE_USE,
                            RULE_WRITEBACK_BEFORE_DROP,
                            RULE_FUSED_TRANSFER, RULE_LAUNCHES,
                            RULE_NO_SYNC_IN_DISPATCH_WINDOW),
    "hybrid-plane-async": (RULE_RESTORE_BEFORE_USE,
                           RULE_WRITEBACK_BEFORE_DROP,
                           RULE_FUSED_TRANSFER, RULE_CTX_LIFETIME,
                           RULE_LAUNCHES,
                           RULE_NO_SYNC_IN_DISPATCH_WINDOW),
    # the fused decode plane: restores land after the forward
    "fused-decode": (RULE_FUSED_TRANSFER, RULE_LAUNCHES),
    # the legacy per-request executors (their per-request saves are
    # waived in-source)
    "legacy": (RULE_FUSED_TRANSFER,),
}

_ENGINE = "src/repro_torch/serving/engine.py"
_POOL = "src/repro_torch/core/device_pool.py"
_PREFILL = "src/repro_torch/core/prefill_plane.py"
_HYBRID = "src/repro_torch/core/hybrid_plane.py"

# the engine helpers a host stage calls, inlined where they are called
_DECODE_STAGE = CallbackSpec("_stage_decode_layer", _ENGINE,
                             "ServingEngine._stage_decode_layer")
_END_OF_LAYER = CallbackSpec("_end_of_layer", _ENGINE,
                             "ServingEngine._end_of_layer")
_ASYNC = (("worker is not None", True),)
_SYNC = (("worker is not None", False),)
_DECODE_BATCH = ("token_by_req", "req_ids", "sts", "rids")
_MIXED_BATCH = ("token_by_req", "req_ids", "rids", "sts", "allow")


def _staged(name: str, protocol: str, assume) -> DriverSpec:
    return DriverSpec(
        name=name, file=_POOL, qualname="DevicePoolPlane.step_staged",
        protocol=protocol,
        callbacks=(CallbackSpec("stage_cb", _ENGINE,
                                "ServingEngine._decode_batch_staged."
                                "stage_cb"),),
        inlines=(_DECODE_STAGE,), batch_iterables=_DECODE_BATCH,
        assume=assume)


def _hybrid(name: str, protocol: str, assume) -> DriverSpec:
    return DriverSpec(
        name=name, file=_HYBRID, qualname="HybridPlane.run_iteration",
        protocol=protocol,
        callbacks=(CallbackSpec("layer_cb", _ENGINE,
                                "ServingEngine._mixed_iteration.layer_cb"),),
        inlines=(_DECODE_STAGE, _END_OF_LAYER),
        batch_iterables=_MIXED_BATCH, assume=assume)


DEFAULT_DRIVERS: Tuple[DriverSpec, ...] = (
    _staged("staged-decode", "staged-decode", _SYNC),
    _staged("staged-decode-async", "staged-decode-async", _ASYNC),
    DriverSpec(
        name="prefill-plane", file=_PREFILL,
        qualname="PrefillPlane.run_iteration", protocol="prefill-plane",
        callbacks=(CallbackSpec(
            "group_cb", _ENGINE,
            "ServingEngine._prefill_plane_iteration.group_cb"),),
        inlines=(_END_OF_LAYER,),
        batch_iterables=("allow", "rids", "req_ids")),
    DriverSpec(
        name="prefill-group", file=_PREFILL,
        qualname="PrefillPlane._run_group",
        protocol="prefill-group", batch_iterables=("rids", "req_ids")),
    _hybrid("hybrid-plane", "hybrid-plane", _SYNC),
    _hybrid("hybrid-plane-async", "hybrid-plane-async", _ASYNC),
    DriverSpec(
        name="hybrid-prefill-layer", file=_PREFILL,
        qualname="PrefillPlane.run_layer", protocol="prefill-group",
        batch_iterables=("rids", "req_ids", "allow")),
    DriverSpec(
        name="fused-decode-selections", file=_ENGINE,
        qualname="ServingEngine._account_selections",
        protocol="fused-decode", inlines=(_DECODE_STAGE,),
        batch_iterables=("sts", "req_ids")),
    DriverSpec(
        name="fused-decode-writeback", file=_ENGINE,
        qualname="ServingEngine._write_back_new_kv",
        protocol="fused-decode", batch_iterables=("sts", "req_ids")),
    DriverSpec(
        name="legacy-layer-segment", file=_ENGINE,
        qualname="ServingEngine._run_layer_segment", protocol="legacy"),
    DriverSpec(
        name="legacy-chunked-prefill", file=_ENGINE,
        qualname="ServingEngine._run_chunked_prefill", protocol="legacy"),
)

# ---------------------------------------------------------------------------
# Launch and host-sync budgets
# ---------------------------------------------------------------------------


def staged_launches_per_iteration(cfg) -> int:
    """Stage launches ONE staged decode iteration issues: embed + logits
    + (select + attend) per attention layer + one per recurrent layer."""
    n_attn = cfg.num_attention_layers()
    return 2 + 2 * n_attn + (cfg.num_layers - n_attn)


def mixed_launches_per_iteration(cfg, n_decode_planes: int, n_groups: int,
                                 n_finalize_planes: int) -> int:
    """Stage launches ONE mixed iteration issues: every decode plane pays
    the staged budget, plus one per executed prefill (layer, chunk) group
    and one finalize per prefill plane with finished rows — independent
    of how many rows ride each plane."""
    return (n_decode_planes * staged_launches_per_iteration(cfg)
            + n_groups + n_finalize_planes)


def staged_host_syncs_per_iteration(cfg) -> int:
    """Blocking syncs ONE staged decode iteration makes on the dispatch
    thread: the copy of the selected ids, once per attention layer (none
    with DSA off)."""
    return cfg.num_attention_layers() if cfg.dsa.enabled else 0

# ---------------------------------------------------------------------------
# Runtime checks: each returns what differs from the contract (empty when
# the run meets it)
# ---------------------------------------------------------------------------


def mixed_launch_mismatches(cfg, log: List[Dict],
                            decode_write_back: bool = True) -> List[str]:
    """Every mixed iteration of an engine's ``mixed_iter_log`` against
    the contract: one fused FlashD2H per attention layer that had work
    (none where write-back is off and no prefill group ran there), at
    most one fused FlashH2D per layer, no transfer at a recurrent layer,
    and the stage launches equal to ``mixed_launches_per_iteration``."""
    out: List[str] = []
    if not log:
        return ["no mixed iteration recorded"]
    for i, entry in enumerate(log):
        for lay, rec in entry["layers"].items():
            if rec["attn"]:
                worked = (rec["decode"] and decode_write_back) \
                    or rec["groups"] > 0
                if rec["d2h"] != (1 if worked else 0) or rec["h2d"] > 1:
                    out.append(f"iteration {i} layer {lay}: {rec}")
            elif rec["d2h"] or rec["h2d"]:
                out.append(f"iteration {i} recurrent layer {lay}: {rec}")
        want = mixed_launches_per_iteration(
            cfg, entry["decode_planes"], entry["groups"], entry["finalize"])
        if entry["launches"] != want:
            out.append(f"iteration {i}: {entry['launches']} launches, the "
                       f"budget is {want}")
    return out


def host_sync_mismatch(cfg, host_syncs: int, iterations: int
                       ) -> Optional[str]:
    """A plane's measured ``host_syncs`` against the budget times the
    iterations it stepped."""
    want = staged_host_syncs_per_iteration(cfg) * iterations
    if host_syncs != want:
        return (f"host_syncs {host_syncs} != {want} "
                f"({iterations} iterations)")
    return None


def _pools(plane):
    """The K / V (MLA: latent) pools of a decode plane's attention
    layers."""
    return [c[key] for c in plane.state["caches"]
            if isinstance(c, dict) and "meta" in c
            for key in ("k", "v") if key in c]


def stripe_bytes(plane) -> int:
    """One row's appended KV stripe over every attention layer of a decode
    plane, as ``new_token_kv_async`` gathers it: float32 (Hkv, D) of K and
    of V (MLA: the latent alone)."""
    return sum(p.shape[1] * p.shape[-1] * 4 for p in _pools(plane))


def stripe_readback_mismatch(plane, rows_stepped: int) -> Optional[str]:
    """The FlashD2H read-back stays stripe-sized: ``d2h_readback_bytes``
    equals one token's stripe per decode row stepped (``rows_stepped``:
    the rows of every step summed), and one step's stripe of every row is
    a vanishing fraction of the pools."""
    want = stripe_bytes(plane) * rows_stepped
    if plane.d2h_readback_bytes != want:
        return (f"d2h_readback_bytes {plane.d2h_readback_bytes} != {want} "
                f"({rows_stepped} rows stepped)")
    pool_bytes = sum(p.numel() * p.element_size() for p in _pools(plane))
    if stripe_bytes(plane) * plane.b_cap >= pool_bytes:
        return "a step's read-back is pool-sized"
    return None

# ---------------------------------------------------------------------------
# Waivers
# ---------------------------------------------------------------------------

WAIVER_RE = re.compile(
    r"#\s*plane-contract:\s*allow\(([a-z0-9-]+)\)\s*(.*)$")


def collect_waivers(source: str) -> Dict[int, Tuple[str, str]]:
    """{line_number: (rule, reason)} for every waiver comment in a file.
    A waiver applies to findings of its rule on its own line or the line
    directly below."""
    out: Dict[int, Tuple[str, str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = WAIVER_RE.search(line)
        if m:
            out[i] = (m.group(1), m.group(2).strip())
    return out


def waiver_for(waivers: Dict[int, Tuple[str, str]], rule: str,
               line: int) -> Optional[str]:
    """The reason string if ``rule`` at ``line`` is waived, else None."""
    for at in (line, line - 1):
        hit = waivers.get(at)
        if hit is not None and hit[0] == rule:
            return hit[1]
    return None

# ---------------------------------------------------------------------------
# Analysis targets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnalysisTarget:
    """What one ``python -m repro_torch.analysis.run`` analyzes: the
    port's tree, or a fixture carrying one planted violation."""
    name: str
    drivers: Tuple[DriverSpec, ...] = ()


DEFAULT_TARGET = AnalysisTarget(name="tree", drivers=DEFAULT_DRIVERS)
