"""The port's discrete-event simulator (``repro_torch.serving.simulator``)
against the reference's, on the CPU: for each of the six systems of the
paper's ladder, on one small trace of the reference's generator (the
port's generator gives the same trace, ``test_torch_trace.py``), the
same metrics, block loads per iteration and batch sizes (the same
numpy arithmetic in the same order: equal, or within 1e-12 relative).
Under the port's ``H100_80G`` every system completes, and dynamic sparse
attention decodes faster than full attention (the paper's Fig. 12)."""
import dataclasses

import pytest

from repro.configs import get_config as jax_cfg
from repro.serving import costmodel as jcm
from repro.serving import simulator as JS
from repro.serving.trace import TraceConfig as JTraceConfig
from repro.serving.trace import generate_trace as j_trace
from repro_torch.configs import get_config as torch_cfg
from repro_torch.serving import costmodel as tcm
from repro_torch.serving import simulator as TS
from repro_torch.serving.trace import TraceConfig, generate_trace

ARCH = "lwm-7b"


def _close(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("system,hw", [(s, "A100_40G") for s in JS.SYSTEMS]
                         + [("sparseserve", "H100_80G"),
                            ("vllm", "H100_80G")])
def test_every_system_matches_the_reference(system, hw):
    """The reference's simulator under the H100 preset: its HardwareSpec
    with the port's fields."""
    tc = dict(request_rate=0.125, num_requests=5, max_new_tokens=40, seed=1)
    thw = getattr(tcm, hw)
    jhw = getattr(jcm, hw, None) or jcm.HardwareSpec(
        **dataclasses.asdict(thw))
    jsim = JS.ServingSimulator(jax_cfg(ARCH), JS.SYSTEMS[system], hw=jhw)
    tsim = TS.ServingSimulator(torch_cfg(ARCH), TS.SYSTEMS[system], hw=thw)
    want = jsim.run(j_trace(JTraceConfig(**tc)))
    got = tsim.run(generate_trace(TraceConfig(**tc)))
    for f in dataclasses.fields(want):
        assert _close(getattr(got, f.name), getattr(want, f.name)), f.name
    assert tsim.loads_per_iter == jsim.loads_per_iter
    assert tsim.batch_sizes == jsim.batch_sizes
    assert TS.SYSTEMS[system] == TS.SystemConfig(**dataclasses.asdict(
        JS.SYSTEMS[system]))


def test_h100_runs_the_ladder():
    cfg = torch_cfg(ARCH)
    trace = lambda: generate_trace(TraceConfig(  # noqa: E731
        request_rate=0.1, num_requests=6, max_new_tokens=48, seed=0))
    metrics = {}
    for name, system in TS.SYSTEMS.items():
        sim = TS.ServingSimulator(cfg, system, hw=tcm.H100_80G)
        metrics[name] = sim.run(trace())
        assert metrics[name].num_finished == 6, name
    assert metrics["vllm-s"].mean_tbt < metrics["vllm"].mean_tbt
    # the card's modelled decode is faster than the paper's A100's
    a100 = TS.ServingSimulator(cfg, TS.SYSTEMS["sparseserve"]).run(trace())
    assert metrics["sparseserve"].mean_tbt < a100.mean_tbt


def test_h100_spec_fields():
    hw = tcm.H100_80G
    assert (hw.peak_flops, hw.hbm_bw) == (989e12, 3.35e12)
    assert 0 < hw.link_eff_fused <= 1
    assert hw.hbm_capacity > 79e9
