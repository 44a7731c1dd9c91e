"""The port's obs layer (``repro_torch.obs`` and its wiring through the
engine and planes) against the reference's (``repro.obs``).

Unit tests mirror ``tests/test_obs.py`` on the port's ``Tracer``,
``MetricsRegistry`` and ``achieved_overlap_fraction``, and hold the last
two against the reference's copies on the same inputs.  The engine tests
run qwen2-0.5b's smoke config with the reference's float32 weights
(through ``bridge.py``) under a 1-block LRU, so every step evicts and
restores, on the CPU with the modelled clock: the mixed and split hybrid
planes on the fp and int8 tiers, then the persistent and stacked decode
paths and chunked prefill.  Obs must not change a token; the snapshot's
keys and its deterministic counters, and the multiset of (name, cat,
layer) over the trace's spans, must equal the JAX engine's on the same
submissions.  Exceptions, both recorded in ROADMAP.md: the port's
``FlashD2H.flush`` span (its pools' flush, the int8 tier's fused save) has
no reference counterpart, and ``plane.trace_count`` (jit traces) is 0."""
import collections
import json
import threading
import time
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.trace_analysis import \
    achieved_overlap_fraction as j_achieved_overlap_fraction
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.host_stage import HostStageWorker
from repro_torch.launch import serve
from repro_torch.obs import (NULL_TRACER, MetricsRegistry, NullTracer,
                             Tracer, achieved_overlap_fraction)
from repro_torch.obs.metrics import _prom_name
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

# the port's span with no reference counterpart (ROADMAP.md, "Conventions
# that differ on purpose")
PORT_ONLY_SPANS = {"FlashD2H.flush"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's runs here use one intra-op thread.  On a CPU shared with
    other test workers, PyTorch's pool of intra-op threads spin-waits
    between ops and starves the engine's host-stage worker thread: a run
    of the async engine then takes 0.03-6 s whether obs is on or off,
    which no wall-clock bar can read."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

def test_tracer_complete_event_shape():
    tr = Tracer()
    t0 = tr.begin()
    time.sleep(0.001)
    tr.end("work", "test", t0, layer=3)
    [ev] = [e for e in tr.events() if e["ph"] == "X"]
    assert ev["name"] == "work" and ev["cat"] == "test"
    assert ev["ts"] >= 0 and ev["dur"] >= 1000       # >= 1 ms in us
    assert isinstance(ev["pid"], int) and ev["tid"] == 1
    assert ev["args"] == {"layer": 3}


def test_tracer_complete_at_uses_caller_times_verbatim():
    tr = Tracer()
    tr.complete_at("x", "c", time.perf_counter(), 0.25)
    [ev] = [e for e in tr.events() if e["ph"] == "X"]
    assert ev["dur"] == pytest.approx(0.25e6)


def test_tracer_span_context_manager():
    tr = Tracer()
    with tr.span("blk", "cat", k=1):
        time.sleep(0.001)
    [ev] = [e for e in tr.events() if e["ph"] == "X"]
    assert ev["name"] == "blk" and ev["dur"] >= 1000
    assert ev["args"] == {"k": 1}


def test_tracer_thread_lanes_and_metadata():
    """A second thread's spans land on their own tid, named by an "M"
    thread_name event."""
    tr = Tracer()
    tr.complete_at("main-span", "c", time.perf_counter(), 0.001)
    th = threading.Thread(target=lambda: tr.complete_at(
        "worker-span", "c", time.perf_counter(), 0.001),
        name="obs-test-worker")
    th.start()
    th.join()
    evs = tr.events()
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert spans["main-span"]["tid"] != spans["worker-span"]["tid"]
    names = {e["args"]["name"]: e["tid"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names["obs-test-worker"] == spans["worker-span"]["tid"]


def test_tracer_monotonic_ts_per_thread():
    tr = Tracer()
    for i in range(16):
        tr.complete_at(f"s{i}", "c", time.perf_counter(), 0.0)
    ts = [e["ts"] for e in tr.events() if e["ph"] == "X"]
    assert ts == sorted(ts)


def test_tracer_chrome_trace_json_round_trip(tmp_path):
    tr = Tracer()
    tr.complete_at("a", "c", time.perf_counter(), 0.002, blocks=7)
    tr.instant("mark", "c")
    back = json.loads(json.dumps(tr.chrome_trace()))
    assert back["displayTimeUnit"] == "ms"
    assert {"M", "X", "i"} <= {e["ph"] for e in back["traceEvents"]}
    for e in back["traceEvents"]:
        assert "pid" in e and "tid" in e and "name" in e
        if e["ph"] == "X":
            assert "ts" in e and "dur" in e
    path = tmp_path / "t.trace.json"
    assert tr.dump_trace(str(path)) == len(back["traceEvents"])
    assert json.loads(path.read_text())["traceEvents"]


def test_null_tracer_surface(tmp_path):
    assert NULL_TRACER.enabled is False
    assert isinstance(NULL_TRACER, NullTracer)
    NULL_TRACER.end("x", "c", 0.0)
    NULL_TRACER.complete_at("x", "c", 0.0, 1.0)
    NULL_TRACER.instant("x")
    with NULL_TRACER.span("x"):
        pass
    assert NULL_TRACER.events() == []
    assert NULL_TRACER.chrome_trace()["traceEvents"] == []
    assert NULL_TRACER.dump_trace(str(tmp_path / "x.json")) == 0


def test_guarded_hot_path_is_allocation_free():
    """Off, an instrumentation point (`if tr.enabled: <emit>`) is one
    attribute read and a branch: nothing is allocated."""
    tr = NULL_TRACER

    def hot(n):
        for _ in range(n):
            if tr.enabled:
                t0 = time.perf_counter()
                tr.end("x", "c", t0)

    hot(10)
    tracemalloc.start()
    hot(10_000)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 1024


# ---------------------------------------------------------------------------
# Metrics registry: the port's and the reference's on the same calls
# ---------------------------------------------------------------------------

def _fill(reg):
    c = reg.counter("a.count", "help")
    c.inc()
    c.inc(2)
    g = reg.gauge("a.depth", "help")
    g.set(5)
    g.inc()
    g.dec(2)
    h = reg.histogram("a.lat_s", "help")
    for v in (1.0, 3.0, 2.0):
        h.observe(v)
    reg.counter("kv.h2d_calls", "fused H2D launches").inc(4)
    reg.histogram("engine.iteration_s", "iter wall").observe(0.5)
    return reg


def test_registry_counter_gauge_histogram():
    s = _fill(MetricsRegistry()).snapshot()
    assert s["a.count"] == 3
    assert s["a.depth"] == 4
    assert s["a.lat_s_count"] == 3
    assert s["a.lat_s_sum"] == pytest.approx(6.0)
    assert s["a.lat_s_min"] == 1.0 and s["a.lat_s_max"] == 3.0
    assert s["a.lat_s_mean"] == pytest.approx(2.0)
    assert s == _fill(JMetricsRegistry()).snapshot()


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_registry_instruments_memoized(kind):
    reg = MetricsRegistry()
    assert getattr(reg, kind)("x", "h") is getattr(reg, kind)("x", "h")


def test_prometheus_text_matches_reference():
    extra = {"plane.count": 2, "obs.enabled": 1.0}
    txt = _fill(MetricsRegistry()).prometheus_text(extra=extra)
    assert "# HELP kv_h2d_calls fused H2D launches" in txt
    assert "# TYPE kv_h2d_calls counter" in txt
    assert "kv_h2d_calls 4" in txt
    assert "engine_iteration_s_count 1" in txt
    assert "engine_iteration_s_sum 0.5" in txt
    assert "plane_count 2" in txt
    assert txt == _fill(JMetricsRegistry()).prometheus_text(extra=extra)


@pytest.mark.parametrize("name,want", [("a.b.c", "a_b_c"),
                                       ("9lives", "_9lives"),
                                       ("sp ace-y", "sp_ace_y")])
def test_prom_name_sanitization(name, want):
    assert _prom_name(name) == want


# ---------------------------------------------------------------------------
# Trace analysis: the port's copy and the reference's on the same events
# ---------------------------------------------------------------------------

def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


OVERLAP_CASES = {
    # worker busy entirely inside the iteration, no dispatch host stage
    "full": ([_ev("iteration", "engine", 0, 1000),
              _ev("host-stage", "host-stage-worker", 100, 200, tid=2)],
             1.0),
    # worker work equal to the dispatch thread's host stage
    "half": ([_ev("iteration", "engine", 0, 1000),
              _ev("host-stage", "host-stage-worker", 100, 300, tid=2),
              _ev("host-stage", "host-stage", 500, 300)], 0.5),
    "worker_outside_iteration": (
        [_ev("iteration", "engine", 0, 100),
         _ev("host-stage", "host-stage-worker", 500, 300, tid=2),
         _ev("host-stage", "host-stage", 0, 100)], 0.0),
    # overlapping worker spans and two iterations: unions, then the
    # intersection (250 of 400 us overlapped, 50 us dispatch-side)
    "unions": ([_ev("iteration", "engine", 0, 200),
                _ev("iteration", "engine", 300, 200),
                _ev("host-stage", "host-stage-worker", 100, 200, tid=2),
                _ev("host-stage", "host-stage-worker", 250, 200, tid=2),
                _ev("host-stage", "host-stage", 20, 50),
                {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2}],
               (100 + 150) / (100 + 150 + 50)),
    "no_events": ([], None),
    "no_worker": ([_ev("iteration", "engine", 0, 100)], None),
    "chrome_dict_empty": ({"traceEvents": []}, None),
    "chrome_dict": ({"traceEvents": [
        _ev("iteration", "engine", 0, 1000),
        _ev("host-stage", "host-stage-worker", 0, 500, tid=2)]}, 1.0),
}


@pytest.mark.parametrize("case", sorted(OVERLAP_CASES))
def test_overlap_fraction_matches_reference(case):
    trace, want = OVERLAP_CASES[case]
    got = achieved_overlap_fraction(trace)
    assert got == j_achieved_overlap_fraction(trace)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


# ---------------------------------------------------------------------------
# The host-stage worker's spans
# ---------------------------------------------------------------------------

def test_worker_emits_spans_on_own_tid():
    tr = Tracer()
    tr.complete_at("dispatch-side", "c", time.perf_counter(), 0.0)
    w = HostStageWorker(name="obs-test-hsw", tracer=tr)
    try:
        for i in range(4):
            w.submit(i % 2, time.sleep, 0.001)
        w.drain()
    finally:
        w.close()
    spans = [e for e in tr.events()
             if e["ph"] == "X" and e["cat"] == "host-stage-worker"]
    assert len(spans) == 4
    main_tid = next(e["tid"] for e in tr.events()
                    if e["ph"] == "X" and e["name"] == "dispatch-side")
    tids = {e["tid"] for e in spans}
    assert len(tids) == 1 and main_tid not in tids
    assert [e["ts"] for e in spans] == sorted(e["ts"] for e in spans)
    assert all(e["args"]["key"] in (0, 1) for e in spans)
    # the spans carry the timing the busy_s counter accumulated
    assert sum(e["dur"] for e in spans) / 1e6 == pytest.approx(w.busy_s,
                                                               rel=1e-9)


def test_worker_without_tracer_emits_nothing():
    w = HostStageWorker(name="obs-test-null")
    try:
        w.submit(0, time.sleep, 0.0)
        w.drain()
    finally:
        w.close()
    assert w.tracer is NULL_TRACER
    assert w.jobs_run == 1 and w.busy_s >= 0.0


# ---------------------------------------------------------------------------
# Engine: the port against the JAX engine on the same submissions
# ---------------------------------------------------------------------------

PROMPTS = (48, 64, 72)
ARRIVALS = (0.0, 1e-4, 3e-3)      # later arrivals land mid-decode
GEN = 5
# snapshot keys whose values are decided by the submissions alone (the
# prefixes cover every key under them)
DETERMINISTIC = ("kv.", "sched.", "engine.iterations",
                 "engine.iteration_s_count", "plane.count", "plane.steps",
                 "plane.host_syncs", "worker.jobs_run")


@pytest.fixture(scope="module")
def setup():
    jc = jax_smoke("qwen2-0.5b")
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), jc.num_layers,
                           device="cpu")
    return jc, torch_smoke("qwen2-0.5b"), jp, tp


def _run(engine_cls, config_cls, request_cls, cfg, params, prompts=PROMPTS,
         arrivals=ARRIVALS, gen=GEN, **kw):
    eng = engine_cls(params, cfg, config_cls(
        r_max=4, chunk_size=64, hbm_blocks_per_request=1, **kw))
    rng = np.random.default_rng(7)
    ids = []
    for p, t in zip(prompts, arrivals):
        r = request_cls(prompt_len=p, max_new_tokens=gen, arrival_time=t)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, p)
                   .astype(np.int32))
        ids.append(r.req_id)
    eng.run()
    return eng, [eng.states[i].out_tokens for i in ids]


@pytest.fixture(scope="module")
def runs(setup):
    """(JAX engine obs on, port obs off, port obs on) per config, each
    with its tokens, made once per module."""
    jc, tc, jp, tp = setup
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = (
                _run(JEngine, JEngineConfig, JRequest, jc, jp, obs=True,
                     **kw),
                _run(ServingEngine, EngineConfig, Request, tc, tp,
                     obs=False, **kw),
                _run(ServingEngine, EngineConfig, Request, tc, tp,
                     obs=True, **kw))
        return cache[key]
    return get


def _spans(eng):
    return [e for e in eng.tracer.events() if e["ph"] == "X"]


def _span_multiset(eng):
    return collections.Counter(
        (e["name"], e["cat"], e.get("args", {}).get("layer"))
        for e in _spans(eng) if e["name"] not in PORT_ONLY_SPANS)


TIERS = [pytest.param(dict(hybrid_plane=p, offload_quant=q), id=f"{p}-{q}")
         for p in ("mixed", "split") for q in ("none", "int8")]


@pytest.mark.parametrize("kw", TIERS)
def test_obs_tokens_equal_off_and_reference(kw, runs):
    (_, j_toks), (off, off_toks), (on, on_toks) = runs(**kw)
    assert on_toks == off_toks == j_toks
    assert off.tracer is NULL_TRACER and off.tracer.events() == []
    s = off.metrics_snapshot()
    assert s["obs.enabled"] == 0.0 and s["obs.trace_events"] == 0.0
    assert off.stage_overlap_from_trace() is None
    assert on.metrics_snapshot()["obs.enabled"] == 1.0


@pytest.mark.parametrize("kw", TIERS)
def test_snapshot_matches_reference(kw, runs):
    """Same key set as the JAX engine's snapshot; the deterministic values
    equal (plane.trace_count, the reference's jit traces, is 0)."""
    (jeng, _), (off, _), (on, _) = runs(**kw)
    want = jeng.metrics_snapshot()
    for eng in (off, on):
        s = eng.metrics_snapshot()
        assert set(s) == set(want)
        assert all(isinstance(v, float) for v in s.values())
        det = {k for k in want if k.startswith(DETERMINISTIC)}
        assert {k: s[k] for k in det} == {k: want[k] for k in det}
        assert s["plane.trace_count"] == 0.0
        assert s["worker.jobs_run"] > 0 and s["kv.evictions"] > 0
    assert on.metrics_snapshot()["obs.trace_events"] == float(
        len(on.tracer.events()))


@pytest.mark.parametrize("kw", TIERS)
def test_span_multiset_matches_reference(kw, runs):
    (jeng, _), _, (on, _) = runs(**kw)
    got = _span_multiset(on)
    assert got == _span_multiset(jeng)
    names = {n for n, _, _ in got}
    assert {"iteration", "select", "attend", "host-stage", "FlashH2D",
            "FlashD2H", "prefill-group"} <= names
    if kw["hybrid_plane"] == "split":
        assert "idx-sync" in names
    # the port-only span is its pools' flush, one per fused save at most
    flush = sum(1 for e in _spans(on) if e["name"] == "FlashD2H.flush")
    assert 0 < flush <= sum(1 for e in _spans(on)
                            if e["name"] == "FlashD2H")


@pytest.mark.parametrize("kw", TIERS)
def test_trace_valid_with_lanes_and_overlap(kw, runs, tmp_path):
    _, _, (on, _) = runs(**kw)
    path = tmp_path / "run.trace.json"
    n = on.dump_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert n == len(evs) > 0
    by_cat = collections.defaultdict(list)
    for e in evs:
        if e["ph"] == "X":
            by_cat[e["cat"]].append(e)
    iters = [e for e in by_cat["engine"] if e["name"] == "iteration"]
    assert len(iters) == on.iterations
    assert by_cat["stage"] and by_cat["host-stage-worker"]
    # the worker's spans have their own lane and overlap iteration spans
    worker_tids = {e["tid"] for e in by_cat["host-stage-worker"]}
    assert worker_tids.isdisjoint({e["tid"] for e in iters})
    assert any(it["ts"] < we["ts"] + we["dur"]
               and we["ts"] < it["ts"] + it["dur"]
               for we in by_cat["host-stage-worker"] for it in iters)
    # the two overlap instruments read one measurement two ways
    measured = on.stage_overlap_measured()
    achieved = on.stage_overlap_from_trace()
    assert measured is not None and achieved is not None
    assert abs(achieved - measured) <= max(0.02, 0.1 * measured)


def test_worker_counters_survive_close_and_prometheus(runs):
    _, _, (on, _) = runs(**TIERS[0].values[0])
    s = on.metrics_snapshot()
    assert s["worker.jobs_run"] > 0
    on.close()
    assert on.metrics_snapshot()["worker.jobs_run"] == s["worker.jobs_run"]
    txt = on.metrics_prometheus()
    assert "# TYPE engine_iteration_s summary" in txt
    assert "kv_h2d_calls" in txt and "obs_enabled 1" in txt


OTHER_PATHS = {"persistent": dict(decode_plane="persistent"),
               "stacked": dict(decode_plane="stacked"),
               "chunked": dict(prefill_mode="chunked")}


@pytest.mark.parametrize("path", sorted(OTHER_PATHS))
def test_other_paths_tokens_and_span_names(path, runs):
    """The oracle paths: obs changes no token, and the trace holds the
    reference's span names (and, but for the port's flush span, its
    (name, cat, layer) multiset)."""
    (jeng, j_toks), (_, off_toks), (on, on_toks) = runs(**OTHER_PATHS[path])
    assert on_toks == off_toks == j_toks
    names = {e["name"] for e in _spans(on)} - PORT_ONLY_SPANS
    assert names == {e["name"] for e in _spans(jeng)}
    assert _span_multiset(on) == _span_multiset(jeng)


def test_repro_obs_env_resolves_into_a_copy(setup, monkeypatch):
    _, tc, _, tp = setup
    monkeypatch.setenv("REPRO_OBS", "1")
    cfg = EngineConfig()
    eng = ServingEngine(tp, tc, cfg)
    assert eng.tracer.enabled and eng.eng.obs is True and cfg.obs is None
    for obj in (eng.kv_mgr, eng.plane, eng.prefill_plane, eng.hybrid,
                eng._stage_worker()):
        assert obj.tracer is eng.tracer
    eng.close()
    monkeypatch.setenv("REPRO_OBS", "0")
    assert ServingEngine(tp, tc, EngineConfig()).tracer is NULL_TRACER


def test_obs_overhead_under_5_percent(setup):
    """Obs on within 5% of obs off (plus 0.25 s of timer noise), best of
    3, as the reference's guard.  The runs alternate off, on, so a change
    in the machine's load between them reaches both."""
    _, tc, _, tp = setup

    def wall(obs):
        t0 = time.perf_counter()
        _run(ServingEngine, EngineConfig, Request, tc, tp, prompts=(64,),
             arrivals=(0.0,), gen=6, obs=obs)
        return time.perf_counter() - t0

    walls = {False: [], True: []}
    for _ in range(3):
        for obs in (False, True):
            walls[obs].append(wall(obs))
    off, on = min(walls[False]), min(walls[True])
    assert on <= off * 1.05 + 0.25, (on, off)


def test_serve_launcher_trace_and_prometheus(tmp_path, capsys):
    out = tmp_path / "serve.trace.json"
    assert serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--prompt", "64", "--gen", "3",
                       "--trace-out", str(out), "--prom"]) == 0
    evs = json.loads(out.read_text())["traceEvents"]
    assert any(e["ph"] == "X" and e["name"] == "iteration" for e in evs)
    text = capsys.readouterr().out
    assert "obs_enabled 1" in text and f"-> {out}" in text
