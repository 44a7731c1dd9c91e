"""The port's synthetic LongBench-shaped trace (``repro_torch.serving.trace``)
against the reference's (``repro.serving.trace``): for the same
``TraceConfig`` both give the same requests, prompt lengths, output
lengths and arrival times bit for bit (both draw from numpy's default
generator in the same order), and ``tiny_trace`` likewise."""
import dataclasses

import pytest

from repro.serving import trace as jtrace
from repro_torch.serving import trace as ttrace
from repro_torch.serving.request import Request


def _fields(reqs):
    return [(r.prompt_len, r.max_new_tokens, r.arrival_time) for r in reqs]


def test_task_mix_and_defaults_are_the_reference():
    assert ttrace.TASK_MIX == jtrace.TASK_MIX
    assert dataclasses.asdict(ttrace.TraceConfig()) == \
        dataclasses.asdict(jtrace.TraceConfig())


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("rate,n,max_prompt,max_new", [
    (0.25, 64, 32768, 512),        # the reference's defaults (LWM's cap)
    (2.0, 4, 32768, 32),           # chip_smoke's qwen2.5-3b trace
    (2.0, 4, 4096, 32),            # its lwm-7b trace
    (0.5, 32, 131072, 256),        # the paper's Llama3 cap
])
def test_generate_trace_equals_reference(seed, rate, n, max_prompt,
                                         max_new):
    kw = dict(request_rate=rate, num_requests=n, max_prompt_len=max_prompt,
              max_new_tokens=max_new, seed=seed)
    got = ttrace.generate_trace(ttrace.TraceConfig(**kw))
    want = jtrace.generate_trace(jtrace.TraceConfig(**kw))
    assert all(isinstance(r, Request) for r in got)
    assert _fields(got) == _fields(want)
    assert len(got) == n
    assert all(128 <= r.prompt_len <= max_prompt
               and 8 <= r.max_new_tokens <= max_new for r in got)
    times = [r.arrival_time for r in got]
    assert times == sorted(times) and times[0] > 0.0


@pytest.mark.parametrize("args", [(), (3, 40, 5, 10.0, 2), (6, 96, 8, 100.0,
                                                           9)])
def test_tiny_trace_equals_reference(args):
    assert _fields(ttrace.tiny_trace(*args)) == \
        _fields(jtrace.tiny_trace(*args))
