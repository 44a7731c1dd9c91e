"""Serving launcher of the port: drive the engine with a synthetic trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        [--requests 8 --prompt 192 --gen 8] [--smoke] [--device cpu]

Random weights from ``--seed`` (bf16 on the GPU, float32 on the CPU).  On
the GPU (the default device) the engine charges wall-clock time, with the
device synchronised at every iteration's end, so the TTFT/TBT printed are
the card's; on the CPU they come from the copied analytic cost model.
Prints TTFT/TBT/throughput and the hierarchical-KV transfer statistics.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=192)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--no-ws", action="store_true")
    ap.add_argument("--cache-blocks", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = M.init_params(cfg, gen, dtype, dev)
    eng = ServingEngine(params, cfg, EngineConfig(
        ws_control=not args.no_ws, hbm_blocks_per_request=args.cache_blocks,
        seed=args.seed, charge_real_time=dev.type == "cuda"))

    rng = np.random.default_rng(args.seed)
    t = 0.0
    for _ in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        eng.submit(Request(prompt_len=args.prompt, max_new_tokens=args.gen,
                           arrival_time=t))
    m = eng.run()
    s = eng.metrics_snapshot()
    where = (f"{torch.cuda.get_device_name(dev)} wall clock"
             if dev.type == "cuda" else "modelled clock, CPU run")
    print(f"arch={cfg.name} device={dev} ({where}) ws={not args.no_ws}")
    print(f"finished={m.num_finished}/{args.requests} "
          f"iters={s['engine.iterations']:.0f}")
    print(f"mean TTFT {m.mean_ttft*1e3:.2f} ms | mean TBT "
          f"{m.mean_tbt*1e3:.3f} ms | {m.token_throughput:.1f} tok/s")
    print(f"FlashH2D: {s['kv.h2d_calls']:.0f} fused launches, "
          f"{s['kv.h2d_blocks']:.0f} blocks, {s['kv.h2d_bytes']/1e6:.2f} MB")
    print(f"FlashD2H: {s['kv.d2h_calls']:.0f} saves, "
          f"{s['kv.d2h_blocks']:.0f} blocks, {s['kv.d2h_bytes']/1e6:.2f} MB")
    tot = max(s["kv.hits"] + s["kv.misses"], 1)
    print(f"HBM cache: {s['kv.hits']:.0f} hits / {s['kv.misses']:.0f} "
          f"misses ({100*s['kv.hits']/tot:.1f}% hit rate), "
          f"{s['kv.evictions']:.0f} evictions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
