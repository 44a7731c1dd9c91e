"""The port's plane contract (``repro_torch.core.plane_contract``) and its
analyzer (``repro_torch.analysis``) against the reference's
(``repro.core.plane_contract``, ``tools/analysis``), on the CPU.

The static pass: the port's tree comes back clean (its two legacy
per-request saves waived in-source), each planted-violation fixture is
flagged by exactly its own rule, the async and sync branches of one
callback body are read apart, the CLI's exit codes and the waiver syntax.
The contract's tables: the budget formulas equal the reference's for
every registry config, and the rule sets of the shared protocols are the
reference's.  At run time: on the reference's smoke submissions (qwen2-
0.5b, float32 weights through ``bridge.py``, a 1-block LRU so every step
evicts and restores; 32-token prefill chunks, so prefill and decode rows
share iterations) the port's ``mixed_iter_log`` equals the JAX
engine's entry for entry, and the port's mixed and staged paths, sync and
async, fp and int8, meet the launch, host-sync and read-back budgets."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import plane_contract as jpc
from repro.models import model as JM
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.analysis import stage_protocol
from repro_torch.analysis.fixtures import FIXTURES
from repro_torch.analysis.run import REPO_ROOT, analyze, main
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import plane_contract as pc
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

_PLANTED = sorted(n for n, (_, rule) in FIXTURES.items() if rule is not None)

# ---------------------------------------------------------------------------
# The static pass
# ---------------------------------------------------------------------------


def test_port_tree_clean():
    """No unwaived finding over the port's drivers; the legacy executors'
    per-request saves are visibly waived, each with its reason."""
    found = analyze(pc.DEFAULT_TARGET)
    assert [f.render() for f in found if not f.waived] == []
    waived = [f for f in found if f.waived]
    assert len(waived) == 2 and all(f.waive_reason for f in waived)
    assert {f.rule for f in waived} == {pc.RULE_FUSED_TRANSFER}


@pytest.mark.parametrize("name", _PLANTED)
def test_fixture_flags_exactly_its_rule(name):
    target, rule = FIXTURES[name]
    found = analyze(target)
    assert found, f"{name}: planted violation not detected"
    assert {f.rule for f in found} == {rule}, [f.render() for f in found]
    assert all(not f.waived for f in found)


def test_fixture_rules_cover_every_rule_and_clean_is_clean():
    assert {rule for _, rule in FIXTURES.values()
            if rule is not None} == set(pc.ALL_RULES)
    target, rule = FIXTURES["clean_mini"]
    assert rule is None and analyze(target) == []


def test_async_and_sync_branches_are_read_apart():
    """One callback body serves both modes: under the async assumption
    the async branch's ``.item()`` is flagged and the sync branch's
    blocking readback is not read; under the sync assumption the
    reverse."""
    target, _ = FIXTURES["bad_sync_in_window"]
    src = (REPO_ROOT / target.drivers[0].file).read_text().splitlines()

    def flagged(assume):
        drv = target.drivers[0].__class__(**{
            **target.drivers[0].__dict__, "assume": assume})
        found = analyze(pc.AnalysisTarget(name="x", drivers=(drv,)))
        return sorted(src[f.line - 1].strip().split("(")[0]
                      for f in found)
    assert flagged((("worker is not None", True),)) == [
        "rows = int"]
    assert flagged((("worker is not None", False),)) == [
        "kv = plane.new_token_kv"]


def test_driver_not_found_fails_the_pass():
    drv = pc.DriverSpec(name="gone", file=pc.DEFAULT_DRIVERS[0].file,
                        qualname="DevicePoolPlane.no_such_driver",
                        protocol="staged-decode")
    with pytest.raises(LookupError):
        analyze(pc.AnalysisTarget(name="gone", drivers=(drv,)))


def test_callback_in_a_loop_is_found():
    """The split path's group callback is defined inside a loop over
    prefill planes; the qualname still reaches it."""
    tree = stage_protocol._parse(REPO_ROOT, "src/repro_torch/serving/"
                                 "engine.py", {})
    assert stage_protocol.find_def(
        tree, "ServingEngine._prefill_plane_iteration.group_cb") is not None


def test_cli_exit_codes(capsys):
    assert main(["--fixture", "bad_double_d2h"]) == 1
    assert main(["--fixture", "clean_mini"]) == 0
    assert main(["--list-fixtures"]) == 0
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "findings=2 unwaived=0" in out
    env = {"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.run",
                        "--fixture", "bad_sync_in_window"],
                       capture_output=True, text=True, env=env,
                       cwd=REPO_ROOT)
    assert r.returncode == 1 and "no-sync-in-dispatch-window" in r.stdout


def test_waiver_parsing_round_trip():
    src = ("x = 1\n"
           "# plane-contract: allow(fused-transfer) legacy executor\n"
           "host.save_contiguous(0, 0, k, v)\n")
    waivers = pc.collect_waivers(src)
    assert waivers == jpc.collect_waivers(src) == {
        2: ("fused-transfer", "legacy executor")}
    assert pc.waiver_for(waivers, "fused-transfer", 3) == "legacy executor"
    assert pc.waiver_for(waivers, "fused-transfer", 5) is None
    assert pc.waiver_for(waivers, "ctx-lifetime", 3) is None

def test_guard_routes_synchronizing_calls_by_thread():
    """The window's guard raises on the thread inside the window and only
    counts another thread's synchronizing calls (the host stage worker's
    waits); other warnings pass through; on the CPU the window is a
    no-op, as the reference's transfer guard is there."""
    import threading
    import warnings

    from repro_torch.device import (GUARD, SyncInDispatchWindow,
                                    dispatch_window)
    msg = "called a synchronizing CUDA operation"
    GUARD.reset()
    with GUARD.routed():
        t = threading.Thread(target=warnings.warn, args=(msg,))
        t.start()
        t.join()
        with pytest.raises(SyncInDispatchWindow):
            warnings.warn(msg)
        with pytest.warns(UserWarning, match="unrelated"):
            warnings.warn("unrelated")
    assert GUARD.snapshot() == {"windows": 1, "flagged": 1,
                                "other_threads": 1}
    with dispatch_window(torch.device("cpu")):
        pass
    assert GUARD.windows == 1

# ---------------------------------------------------------------------------
# The contract's tables against the reference's
# ---------------------------------------------------------------------------


def test_rule_ids_and_protocols_are_the_reference():
    assert set(pc.ALL_RULES) < set(jpc.ALL_RULES)
    assert {r for r, _ in pc.NO_COUNTERPART} == \
        set(jpc.ALL_RULES) - set(pc.ALL_RULES)
    assert pc.PROTOCOL_RULES == jpc.PROTOCOL_RULES
    assert {d.name for d in pc.DEFAULT_DRIVERS} == \
        {d.name for d in jpc.DEFAULT_DRIVERS}
    assert {d.name: d.protocol for d in pc.DEFAULT_DRIVERS} == \
        {d.name: d.protocol for d in jpc.DEFAULT_DRIVERS}


@pytest.mark.parametrize("scale", ["full", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_budgets_equal_the_reference(arch, scale):
    assert arch in J_ARCHS
    tc = (torch_config if scale == "full" else torch_smoke)(arch)
    jc = (jax_config if scale == "full" else jax_smoke)(arch)
    assert pc.staged_launches_per_iteration(tc) == \
        jpc.staged_launches_per_iteration(jc)
    assert pc.staged_host_syncs_per_iteration(tc) == \
        jpc.staged_host_syncs_per_iteration(jc)
    for planes, groups, fin in ((1, 0, 0), (2, 5, 1), (3, 17, 2)):
        assert pc.mixed_launches_per_iteration(tc, planes, groups, fin) == \
            jpc.mixed_launches_per_iteration(jc, planes, groups, fin)

# ---------------------------------------------------------------------------
# The budgets at run time, against the JAX engine's log
# ---------------------------------------------------------------------------

PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)
GEN = 5


def _run(engine_cls, config_cls, request_cls, cfg, params, **kw):
    eng = engine_cls(params, cfg, config_cls(
        r_max=4, chunk_size=64, hbm_blocks_per_request=1,
        prefill_max_tokens_per_step=32, **kw))
    rng = np.random.default_rng(7)
    ids = []
    for p, t in zip(PROMPTS, ARRIVALS):
        r = request_cls(prompt_len=p, max_new_tokens=GEN, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32))
        ids.append(r.req_id)
    eng.run()
    return eng, [eng.states[i].out_tokens for i in ids]


@pytest.fixture(scope="session")
def contract_runs():
    """{config key: (engine, tokens)} of qwen2-0.5b's smoke with the
    reference's weights, made once per session; key "jax" is the JAX
    engine's mixed run."""
    jc = jax_smoke("qwen2-0.5b")
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tc = torch_smoke("qwen2-0.5b")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                           device="cpu")
    cache = {}

    def get(key, **kw):
        if key not in cache:
            cache[key] = (_run(JEngine, JEngineConfig, JRequest, jc, jp, **kw)
                          if key == "jax" else
                          _run(ServingEngine, EngineConfig, Request, tc, tp,
                               **kw))
        return cache[key]
    return get


PATHS = [pytest.param(dict(hybrid_plane=h, stage_dispatch=s,
                           offload_quant=q), id=f"{h}-{s}-{q}")
         for h in ("mixed", "split") for s in ("async", "sync")
         for q in ("none", "int8")]


def test_mixed_log_equals_the_reference(contract_runs):
    """Entry for entry: the stage launches, prefill groups, finalizes and
    every layer's fused-transfer counts of each mixed iteration."""
    jeng, jtoks = contract_runs("jax")
    eng, toks = contract_runs("mixed-async-none", hybrid_plane="mixed",
                              stage_dispatch="async", offload_quant="none")
    assert toks == jtoks
    assert len(eng.mixed_iter_log) == len(jeng.mixed_iter_log) > 0
    for got, want in zip(eng.mixed_iter_log, jeng.mixed_iter_log):
        assert {k: got[k] for k in ("launches", "groups", "finalize",
                                    "decode_planes", "decode_rows",
                                    "prefill_rows")} == \
            {k: want[k] for k in ("launches", "groups", "finalize",
                                  "decode_planes", "decode_rows",
                                  "prefill_rows")}
        assert got["layers"] == want["layers"]
    assert any(e["decode_rows"] and e["prefill_rows"]
               for e in eng.mixed_iter_log)


@pytest.mark.parametrize("kw", PATHS)
def test_paths_meet_the_budgets(kw, contract_runs):
    key = "-".join(kw[k] for k in ("hybrid_plane", "stage_dispatch",
                                   "offload_quant"))
    eng, _ = contract_runs(key, **kw)
    if kw["hybrid_plane"] == "mixed":
        assert pc.mixed_launch_mismatches(
            eng.cfg, eng.mixed_iter_log, eng.eng.decode_write_back) == []
    else:
        assert eng.mixed_iter_log == []
    plane = eng.plane
    assert plane.steps > 0
    assert pc.host_sync_mismatch(eng.cfg, plane.host_syncs,
                                 plane.steps) is None
    assert pc.stripe_readback_mismatch(plane, eng.decode_tokens) is None


def test_budget_checks_reject_planted_faults(contract_runs):
    """An extra stage launch, a missing host sync and a pool-sized
    read-back are each reported."""
    eng, _ = contract_runs("mixed-async-none", hybrid_plane="mixed",
                           stage_dispatch="async", offload_quant="none")
    log = [dict(e) for e in eng.mixed_iter_log]
    log[-1]["launches"] += 1
    bad = pc.mixed_launch_mismatches(eng.cfg, log)
    assert len(bad) == 1 and "launches" in bad[0]
    plane = eng.plane
    assert pc.host_sync_mismatch(eng.cfg, plane.host_syncs - 1,
                                 plane.steps) is not None
    assert pc.stripe_readback_mismatch(plane, eng.decode_tokens + 1) \
        is not None


def test_hybrid_mixed_walk_meets_the_budgets():
    """The recurrent layers' stages count in the budget too: jamba's
    smoke (Mamba and attention layers) on the mixed path, port only."""
    tc = torch_smoke("jamba-v0.1-52b")
    from repro_torch.models import model as M
    tp = M.init_params(tc, torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    eng, _ = _run(ServingEngine, EngineConfig, Request, tc, tp)
    assert pc.mixed_launch_mismatches(tc, eng.mixed_iter_log) == []
    assert pc.host_sync_mismatch(tc, eng.plane.host_syncs,
                                 eng.plane.steps) is None
    assert pc.staged_launches_per_iteration(tc) > \
        2 + 2 * tc.num_attention_layers()
