"""Synthetic LongBench-like workload traces (paper §4.1).

The paper mixes QA / summarization / code tasks from LongBench into one
trace and draws arrival times from a Poisson process at a configurable
request rate.  No datasets ship offline, so we synthesize the same
statistical shape: per-task-type lognormal prompt/output length
distributions calibrated to LongBench's published statistics, mixed
uniformly, Poisson arrivals, prompt lengths capped like the paper
(32k for LWM-7B, 128k for Llama3-8B).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.serving.request import Request

# (name, median prompt tokens, sigma, median output tokens)
TASK_MIX = [
    ("qasper",       4000, 0.6,  96),
    ("narrativeqa", 18000, 0.5, 64),
    ("multifieldqa", 5000, 0.6, 96),
    ("dureader",    14000, 0.4, 128),
    ("govreport",    9000, 0.5, 384),
    ("qmsum",       11000, 0.4, 256),
    ("multinews",    2200, 0.6, 320),
    ("vcsum",       16000, 0.4, 256),
    ("lcc",          2500, 0.8, 64),
    ("repobench-p", 10000, 0.6, 64),
]


@dataclasses.dataclass
class TraceConfig:
    request_rate: float = 0.25        # req/s (Poisson)
    num_requests: int = 64
    max_prompt_len: int = 32768       # paper: 32k (LWM) / 128k (Llama3)
    max_new_tokens: int = 512
    seed: int = 0


def generate_trace(cfg: TraceConfig) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    reqs: List[Request] = []
    t = 0.0
    for i in range(cfg.num_requests):
        t += rng.exponential(1.0 / cfg.request_rate)
        name, med_p, sig, med_o = TASK_MIX[rng.integers(len(TASK_MIX))]
        plen = int(np.clip(rng.lognormal(np.log(med_p), sig), 128,
                           cfg.max_prompt_len))
        olen = int(np.clip(rng.lognormal(np.log(med_o), 0.5), 8,
                           cfg.max_new_tokens))
        reqs.append(Request(prompt_len=plen, max_new_tokens=olen,
                            arrival_time=t))
    return reqs


def tiny_trace(num_requests: int = 4, prompt_len: int = 96,
               max_new_tokens: int = 8, rate: float = 100.0,
               seed: int = 0) -> List[Request]:
    """Small fixed-shape trace for the real-execution engine tests."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(num_requests):
        t += rng.exponential(1.0 / rate)
        out.append(Request(prompt_len=prompt_len,
                           max_new_tokens=max_new_tokens, arrival_time=t))
    return out
