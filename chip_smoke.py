#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--phases build,parity,serve,async]

Run from the repository root on a machine with one NVIDIA H100.  Phases,
each printing one line (``phase=...``) and failing the run on any error:

1. build  — compile the four CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, all at once; an unchanged source is reused from
   the build directory) and print the build seconds.
2. parity — hold each kernel against its plain PyTorch version on the card
   in bf16, at qwen2-0.5b shapes (Hq 14, Hkv 2, D 64) and llama3-8b shapes
   (Hq 32, Hkv 8, D 128), with bs 32, K 64, NB 256, B 8, scatter in both
   of its modes (batched rows with a float32 payload, as a restore; one row
   with a bf16 payload, as a drop); time kernel, plain version and bound.
   Tolerances: gather and scatter bit-exact; block_score
   |err| <= 1e-3 + 1e-4 |ref| (float32 sums in another order);
   sparse_decode_attention |err| <= 2e-3 + 1e-2 |ref| (both accumulate in
   float32 and round once to bf16, whose step is <= 2^-7 relative).  Two
   planted faults (cur_len one block short; one live selection's valid
   flag cleared) must fail that tolerance.
3. serve  — the port's ServingEngine, default config, on qwen2-0.5b at
   full width (24 layers, bf16, random weights from --seed): 4 requests of
   4096 prompt tokens and 32 new tokens, wall-clock charging.  Asserts
   every request finished with finite logits, that each kernel was
   launched on this path, and that H2D restores and D2H saves happened.
   The inputs of one launch of each kernel (and of each scatter mode) from
   the decode step halfway through the run, when all 4 requests decode
   together, are kept.
4. mainpath — those kept launches replayed: each kernel against its plain
   version at the serve path's own shapes, modes and data, with the
   tolerances of phase 2.  The kernels' JSON record takes its times and
   bounds from here.
5. async  — the same submissions at full width and 4 layers with
   stage_dispatch "async" and "sync": greedy tokens and transfer counters
   must be identical.
6. profile (only when named in --phases) — the serve run again under
   torch.profiler: device busy time, idle share, largest device consumers.

Before the last line it prints the kernels' JSON record and the card's
name and power limit; the last line is the device JSON.  Without CUDA, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (data sheet)
BF16_OPS_PER_S = 989e12              # H100 SXM dense bf16 tensor peak
PHASES = ("build", "parity", "serve", "async")

KERNELS = {   # name -> (source in this repo, the TPU kernel it replaces)
    "sparse_decode_attention": (
        "src/repro_torch/csrc/sparse_decode_attention.cu",
        "src/repro/kernels/sparse_decode_attention.py:76"),
    "block_score": ("src/repro_torch/csrc/block_score.cu",
                    "src/repro/kernels/block_score.py:34"),
    "gather_blocks_hkv": ("src/repro_torch/csrc/gather_blocks.cu",
                          "src/repro/kernels/gather_blocks.py:57"),
    "scatter_blocks_hkv": ("src/repro_torch/csrc/scatter_blocks.cu",
                           "src/repro/kernels/scatter_blocks.py:61"),
}
SHAPES = {"qwen2-0.5b": dict(Hq=14, Hkv=2, D=64),
          "llama3-8b": dict(Hq=32, Hkv=8, D=128)}
B, BS, K, NB = 8, 32, 64, 256
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2
SCORE_ATOL, SCORE_RTOL = 1e-3, 1e-4
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 4096, 32


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median time of one call, each launch timed alone with CUDA events
    after a 256 MB write that evicts the 50 MB L2 (the serving path finds
    its inputs cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 20) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


# --- one case per kernel: kernel against plain version on given inputs ---
# Each returns (max_abs_err, ok, kernel fn, plain fn, bytes, ops, shape).

def _attn_close(out, want) -> tuple:
    err = (out.float() - want.float()).abs()
    return (err.max().item(),
            bool((err <= ATTN_ATOL + ATTN_RTOL * want.float().abs()).all()))


def case_attention(torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len):
    args = (q, k_pool, v_pool, idx, valid, cur_len)
    out = ops.sparse_decode_attention(*args)
    want = ref.sparse_decode_attention(*args)
    torch.cuda.synchronize()
    err, ok = _attn_close(out, want)
    B, Hq, _ = q.shape
    _, Hkv, NB, bs, D = k_pool.shape
    Dv = v_pool.shape[-1]
    # blocks the kernel must read: valid selections starting below cur_len
    live = int((valid & (idx * bs < cur_len[:, None, None])).sum().item())
    nbytes = (q.numel() * 2 + live * bs * (D + Dv) * 2 + idx.numel() * 5
              + cur_len.numel() * 4 + out.numel() * 2)
    nops = live * (Hq // Hkv) * bs * 2 * (D + Dv)
    shape = (f"B={B} Hq={Hq} Hkv={Hkv} NB={NB} K={idx.shape[-1]} bs={bs} "
             f"D={D} live_blocks={live}")
    return (err, ok, lambda: ops.sparse_decode_attention(*args),
            lambda: ref.sparse_decode_attention(*args), nbytes, nops, shape)


def case_score(torch, ops, ref, q, meta):
    out = ops.block_score(q, meta)
    want = ref.block_score(q, meta)
    torch.cuda.synchronize()
    err = (out - want).abs()
    ok = bool((err <= SCORE_ATOL + SCORE_RTOL * want.abs()).all())
    B, Hq, D = q.shape
    _, Hkv, NB, _, _ = meta.shape
    return (err.max().item(), ok, lambda: ops.block_score(q, meta),
            lambda: ref.block_score(q, meta),
            q.numel() * 2 + meta.numel() * 4 + out.numel() * 4,
            B * Hkv * NB * (Hq // Hkv) * 4 * D,
            f"B={B} Hq={Hq} Hkv={Hkv} NB={NB} D={D}")


def case_gather(torch, ops, ref, pool, idx):
    """pool on the card or pinned on the host; idx on the card."""
    idx_p = idx.to(pool.device)
    out = ops.gather_blocks_hkv(pool, idx)
    want = ref.gather_blocks_hkv(pool, idx_p).to(idx.device)
    torch.cuda.synchronize()
    H, NB, bs, D = pool.shape
    K = idx.shape[0]
    return ((out.float() - want.float()).abs().max().item(),
            bool(torch.equal(out, want)),
            lambda: ops.gather_blocks_hkv(pool, idx),
            lambda: ref.gather_blocks_hkv(pool, idx_p).to(
                idx.device, non_blocking=True),
            2 * H * K * bs * D * pool.element_size() + K * 4, 0,
            f"pool=({H},{NB},{bs},{D}) {str(pool.dtype)[6:]} "
            f"{'pinned host' if pool.device.type == 'cpu' else 'device'} "
            f"K={K}")


def case_scatter(torch, ops, ref, pool, payload, dest, rows=None):
    got = ops.scatter_blocks_hkv(pool.clone(), payload, dest, rows)
    want = ref.scatter_blocks_hkv(pool.clone(), payload, dest, rows)
    torch.cuda.synchronize()
    pool_k, pool_p = pool.clone(), pool.clone()
    H, K, bs, D = payload.shape
    return ((got.float() - want.float()).abs().max().item(),
            bool(torch.equal(got, want)),
            lambda: ops.scatter_blocks_hkv(pool_k, payload, dest, rows),
            lambda: ref.scatter_blocks_hkv(pool_p, payload, dest, rows),
            H * K * bs * D * (payload.element_size() + pool.element_size())
            + K * 4 * (1 if rows is None else 2), 0,
            f"pool={tuple(pool.shape)} payload=({H},{K},{bs},{D}) "
            f"{str(payload.dtype)[6:]} rows={'none' if rows is None else K}")


def run_case(phase: str, label: str, name: str, case: tuple,
             timer) -> dict:
    """Time one case, print its line, fail on disagreement."""
    err, ok, kfn, pfn, nbytes, nops, shape = case
    k_ms, p_ms = timer(kfn), timer(pfn)
    b_ms, b_by = bound_ms(nbytes, nops)
    log(f"phase={phase} {label} kernel={name} ok={ok} max_abs_err={err:.3e} "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms=None "
        f"bound_ms={b_ms:.4f} bound_by={b_by} shape=[{shape}]")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({phase} {label}, max abs err {err})")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "shape": shape}


def planted_faults(torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len,
                   arch: str) -> None:
    """The attention tolerance must reject a kernel that masks one block
    wrong: run the kernel on inputs with a planted fault and hold it
    against the plain version on the true inputs."""
    want = ref.sparse_decode_attention(q, k_pool, v_pool, idx, valid,
                                       cur_len)
    bs = k_pool.shape[3]
    flipped = valid.clone()
    flipped[1, 0, 1] = False           # a whole live block (the one
    #                                    before the block of cur_len - 1)
    for label, args in (
            ("cur_len_one_block_short",
             (q, k_pool, v_pool, idx, valid, cur_len - bs)),
            ("one_valid_flag_cleared",
             (q, k_pool, v_pool, idx, flipped, cur_len))):
        err, ok = _attn_close(ops.sparse_decode_attention(*args), want)
        log(f"phase=parity arch={arch} planted_fault={label} "
            f"max_abs_err={err:.3e} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {label} passed the "
                                 f"attention tolerance at {arch} shapes")


def phase_parity(torch, ops, ref, timer, seed: int) -> dict:
    """Each kernel against its plain version at both shape sets; returns
    {kernel: {case label: result}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    results = {}
    for arch, sh in SHAPES.items():
        Hq, Hkv, D = sh["Hq"], sh["Hkv"], sh["D"]

        def randn(*shape, dtype=bf):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        # sparse_decode_attention: random selections, about 60% of them
        # skipped (invalid or past cur_len), plus the two blocks holding
        # the last bs positions before cur_len, which DSA always selects
        q = randn(B, Hq, D)
        k_pool, v_pool = randn(B, Hkv, NB, BS, D), randn(B, Hkv, NB, BS, D)
        cur_len = torch.randint(K * BS // 2, NB * BS + 1, (B,),
                                generator=gen, device=dev,
                                dtype=torch.int32)
        pick = torch.rand((B, Hkv, NB), generator=gen, device=dev)
        last = ((cur_len.long() - 1) // BS)[:, None, None]
        pick.scatter_(2, last.expand(B, Hkv, 1), 3.0)
        pick.scatter_(2, (last - 1).expand(B, Hkv, 1), 2.0)
        idx = pick.argsort(dim=-1, descending=True)[..., :K].to(
            torch.int32).contiguous()
        valid = torch.rand((B, Hkv, K), generator=gen, device=dev) > 0.1
        valid[..., :2] = True
        valid[0, 0] = False                  # a row with no valid position
        attn = (q, k_pool, v_pool, idx, valid, cur_len)
        cases = [("sparse_decode_attention", "",
                  case_attention(torch, ops, ref, *attn))]
        planted_faults(torch, ops, ref, *attn, arch)

        # block_score (meta in the pool's interleaved layout)
        mn = randn(B, Hkv, NB, D, dtype=torch.float32)
        mx = mn + torch.rand((B, Hkv, NB, D), generator=gen, device=dev)
        meta = torch.stack([mn, mx], dim=3).contiguous()
        cases.append(("block_score", "", case_score(torch, ops, ref, q,
                                                     meta)))

        # gather_blocks_hkv: pinned float32 host pool -> device
        cpu_gen = torch.Generator().manual_seed(seed)
        host_pool = torch.randn((Hkv, NB, BS, D),
                                generator=cpu_gen).pin_memory()
        gidx = torch.randperm(NB, generator=cpu_gen)[:K].to(torch.int32)
        cases.append(("gather_blocks_hkv", "", case_gather(
            torch, ops, ref, host_pool, gidx.to(dev))))

        # scatter_blocks_hkv: a restore (float32 payload, batched rows) and
        # a drop (bf16 payload into one row's pool)
        pool = randn(B, Hkv, NB, BS, D)
        dest = torch.randperm(NB, generator=gen, device=dev)[:K].to(
            torch.int32)
        rows = torch.randint(0, B, (K,), generator=gen, device=dev,
                             dtype=torch.int32)
        cases.append(("scatter_blocks_hkv", "mode=rows", case_scatter(
            torch, ops, ref, pool, randn(Hkv, K, BS, D, dtype=torch.float32),
            dest, rows)))
        cases.append(("scatter_blocks_hkv", "mode=drop", case_scatter(
            torch, ops, ref, pool[3].clone(), randn(Hkv, K, BS, D), dest)))

        for name, mode, case in cases:
            label = f"arch={arch} {mode}".strip()
            results.setdefault(name, {})[label] = run_case(
                "parity", label, name, case, timer)
    return results


class MainPathCapture:
    """While active, wraps the four kernel wrappers of ``ops`` to count
    their calls per case (scatter splits into its restore mode, ``rows``,
    and its drop mode, ``drop``) and to keep a copy of the inputs of one
    launch per case: the first made from attention launch ``from_attn``
    on (one attention launch per layer and decode step; the first decode
    steps run fewer requests, as prefills finish one after another).  A
    pinned host pool is kept by reference."""

    def __init__(self, torch, ops, from_attn: int):
        self.torch, self.ops = torch, ops
        self.from_attn = from_attn
        self.orig = {}
        self.calls = {}
        self.inputs = {}

    def __enter__(self):
        for name in self.ops.launches.NAMES:
            self.orig[name] = getattr(self.ops, name)
            setattr(self.ops, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def _keep(self, a):
        if isinstance(a, self.torch.Tensor) and not a.is_pinned():
            return a.clone()
        return a

    def _wrap(self, name, fn):
        def wrapped(*args):
            key = name
            if name == "scatter_blocks_hkv":
                rows = args[3] if len(args) > 3 else None
                key = f"{name}:{'drop' if rows is None else 'rows'}"
            self.calls[key] = self.calls.get(key, 0) + 1
            if (self.calls.get("sparse_decode_attention", 0)
                    >= self.from_attn and key not in self.inputs):
                self.inputs[key] = tuple(self._keep(a) for a in args)
            return fn(*args)
        return wrapped


def phase_mainpath(torch, ops, ref, timer, cap: MainPathCapture) -> dict:
    """Replay the kept main-path launches: {kernel: {case: result}}."""
    makers = {"sparse_decode_attention": case_attention,
              "block_score": case_score,
              "gather_blocks_hkv": case_gather,
              "scatter_blocks_hkv": case_scatter}
    results = {}
    for key, args in sorted(cap.inputs.items()):
        name = key.split(":")[0]
        mode = key.split(":")[1] if ":" in key else ""
        label = f"mode={mode}".strip() if mode else "serve"
        res = run_case("mainpath", label, name,
                       makers[name](torch, ops, ref, *args), timer)
        res["launches"] = cap.calls[key]
        results.setdefault(name, {})[label] = res
    missing = set(ops.launches.NAMES) - set(results)
    if missing:
        raise AssertionError(f"no mid-run launch kept for {missing}")
    return results


def kernel_records(parity: dict, mainpath: dict, counts: dict) -> list:
    """The kernels' JSON record: times and bound from the main-path replay
    (for scatter, the mode with the most launches; every case is listed
    under "cases"), else from the qwen2-0.5b parity case; max_abs_err over
    every case."""
    records = []
    for name in KERNELS:
        cases = mainpath.get(name) or parity.get(name, {})
        if not cases:
            continue
        lead = max(cases.values(), key=lambda r: r.get("launches", 0))
        every = list(parity.get(name, {}).values()) + list(
            mainpath.get(name, {}).values())
        records.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": counts.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": None,
            "cases": {label: {k: r[k] for k in ("shape", "ms", "plain_ms",
                                                "bound_ms", "launches")
                              if k in r}
                      for label, r in cases.items()}})
    return records


def _submit_all(eng, Request, cfg, np, seed: int, n: int, prompt: int,
                gen: int) -> list:
    rng = np.random.default_rng(seed)
    ids = []
    for _ in range(n):
        r = Request(prompt_len=prompt, max_new_tokens=gen, arrival_time=0.0)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, prompt)
                   .astype(np.int32))
        ids.append(r.req_id)
    return ids


def _serve_qwen2(torch, np, seed: int, **engine_kw):
    """The port's engine on qwen2-0.5b at full width, 4 x 4096-token
    prompts, 32 new tokens each, submitted (not yet run)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    eng = ServingEngine(params, cfg, EngineConfig(seed=seed, **engine_kw))
    ids = _submit_all(eng, Request, cfg, np, seed, SERVE_REQUESTS,
                      SERVE_PROMPT, SERVE_NEW)
    torch.cuda.synchronize()
    return eng, ids


def phase_serve(torch, np, ops, seed: int) -> tuple:
    """Returns the launch counts of the run and its MainPathCapture."""
    eng, ids = _serve_qwen2(torch, np, seed, charge_real_time=True)
    torch.cuda.reset_peak_memory_stats()
    from_attn = eng.cfg.num_layers * SERVE_NEW // 2    # a mid-run step
    with MainPathCapture(torch, ops, from_attn) as cap:
        ops.launches.reset()
        t0 = time.perf_counter()
        m = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launches.snapshot()
    for rid in ids:
        st = eng.states[rid]
        if len(st.out_tokens) != SERVE_NEW:
            raise AssertionError(f"{rid}: {len(st.out_tokens)} tokens")
        if not bool(torch.isfinite(st.last_logits).all()):
            raise AssertionError(f"{rid}: non-finite logits")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    s = eng.metrics_snapshot()
    if s["kv.h2d_calls"] <= 0 or s["kv.d2h_calls"] <= 0:
        raise AssertionError("no H2D restore or no D2H save happened")
    log(f"phase=serve model=qwen2-0.5b layers={eng.cfg.num_layers} "
        f"requests={len(ids)} prompt={SERVE_PROMPT} new={SERVE_NEW} "
        f"finished={m.num_finished} wall_s={wall:.3f} "
        f"mean_ttft_ms={m.mean_ttft * 1e3:.2f} "
        f"mean_tbt_ms={m.mean_tbt * 1e3:.3f} "
        f"p99_tbt_ms={(m.p99_tbt or 0.0) * 1e3:.3f} "
        f"tok_per_s={m.token_throughput:.1f} iterations={eng.iterations}")
    log("phase=serve transfer " + " ".join(
        f"{k}={v:.0f}" for k, v in s.items()
        if k.startswith(("kv.", "plane."))))
    log("phase=serve launches " + json.dumps(counts) + " by case "
        + json.dumps(cap.calls))
    log(f"phase=serve peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    eng.close()
    return counts, cap


def phase_profile(torch, np, seed: int) -> None:
    """The serve phase's run again under ``torch.profiler``: device busy
    time (the sum of the device-side events' times; the port runs one
    stream) against the wall clock gives the device's idle share; the
    largest device consumers follow.  Not part of the default phases: the
    profiler slows the host, so its wall clock is not the serve phase's."""
    from torch.profiler import ProfilerActivity, profile
    eng, _ = _serve_qwen2(torch, np, seed, charge_real_time=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, memsets): a CPU op's
        # device time repeats that of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    log(f"phase=profile wall_s={wall:.3f} device_busy_s={busy:.3f} "
        f"idle_share={1.0 - busy / wall:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"phase=profile device_ms={dev_us / 1e3:.2f} calls={count} "
            f"kernel={key[:90]}")


def phase_async(torch, np, seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    out = {}
    for mode in ("async", "sync"):
        eng = ServingEngine(params, cfg, EngineConfig(stage_dispatch=mode,
                                                      seed=seed))
        ids = _submit_all(eng, Request, cfg, np, seed, SERVE_REQUESTS,
                          SERVE_PROMPT, SERVE_NEW)
        eng.run()
        out[mode] = ([eng.states[r].out_tokens for r in ids],
                     dataclasses.asdict(eng.transfer_stats()))
    same = out["async"] == out["sync"]
    log(f"phase=async layers=4 tokens_identical={same} "
        f"h2d_calls={out['async'][1]['h2d_calls']} "
        f"d2h_calls={out['async'][1]['d2h_calls']}")
    if not same:
        raise AssertionError("async and sync engines disagree")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of build,parity,serve,async"
                         " (serve includes mainpath) plus the optional "
                         "profile")
    args = ap.parse_args()
    phases = args.phases.split(",")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import LIBS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = LIBS.build()
    regs = {k: " | ".join(line.split("ptxas info    : ")[-1]
                          for line in v.splitlines() if "registers" in line)
            for k, v in LIBS.ptxas_info.items()}
    log(f"phase=build seconds={secs:.1f} rebuilt={LIBS.rebuilt} "
        f"ptxas={json.dumps(regs)}")
    timer = Timer(torch)
    parity, mainpath, counts = {}, {}, {}
    if "parity" in phases:
        parity = phase_parity(torch, ops, ref, timer, args.seed)
    if "serve" in phases:
        counts, cap = phase_serve(torch, np, ops, args.seed)
        mainpath = phase_mainpath(torch, ops, ref, timer, cap)
        del cap
    records = kernel_records(parity, mainpath, counts)
    if "async" in phases:
        phase_async(torch, np, args.seed)
    if "profile" in phases:
        phase_profile(torch, np, args.seed)
    log(json.dumps({"kernels": records}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
