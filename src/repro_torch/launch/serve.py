"""Serving launcher of the port: drive the engine with a synthetic trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        [--requests 8 --prompt 192 --gen 8] [--smoke] [--device cpu]
        [--prefill {layer_segmented,chunked} --chunk 64]
        [--obs] [--trace-out run.trace.json] [--prom]

Random weights from ``--seed`` (bf16 on the GPU, float32 on the CPU).
The frontend models' requests carry synthesized tensors, float32 from
the same seed with numpy (``frontend_inputs``): internvl2-2b's
``patch_embeds`` (1, 256, 2048), whisper-small's ``frames`` (1, 1500,
768), the stubbed ViT's and conv/mel frontend's outputs.  RWKV6
(rwkv6-1.6b) caches no KV: its transfer counters stay 0.  On
the GPU (the default device) the engine charges wall-clock time, with the
device synchronised at every iteration's end, so the TTFT/TBT printed are
the card's; on the CPU they come from the copied analytic cost model.
Prints each request's generated tokens, TTFT/TBT/throughput and the
hierarchical-KV transfer statistics, read from
``engine.metrics_snapshot()``.  ``--trace-out`` writes the run's
Chrome trace-event JSON (open it in https://ui.perfetto.dev); ``--prom``
prints the Prometheus text exposition of the final snapshot.
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


def frontend_inputs(cfg, rng: np.random.Generator) -> dict:
    """One request's frontend tensors for ``cfg``, float32 normals of
    the embeddings' scale (0.02) with a leading batch axis of 1: the
    VLM's ``patch_embeds`` (1, num_patches, d), Whisper's ``frames`` (1,
    encoder_seq_len, d); {} for a decoder-only config."""
    out = {}
    if cfg.frontend == "vit_patch_stub":
        out["patch_embeds"] = (0.02 * rng.standard_normal(
            (1, cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = (0.02 * rng.standard_normal(
            (1, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=192)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--prefill", default="layer_segmented",
                    choices=["layer_segmented", "chunked"])
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--no-ws", action="store_true")
    ap.add_argument("--cache-blocks", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--obs", action="store_true",
                    help="enable the tracing+metrics layer (EngineConfig"
                         ".obs; also via REPRO_OBS=1)")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace-event JSON here (implies "
                         "--obs; open in ui.perfetto.dev)")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus text exposition of the "
                         "final metrics snapshot")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = M.init_params(cfg, gen, dtype, dev)
    eng = ServingEngine(params, cfg, EngineConfig(
        prefill_mode=args.prefill, chunk_size=args.chunk,
        ws_control=not args.no_ws, hbm_blocks_per_request=args.cache_blocks,
        seed=args.seed, charge_real_time=dev.type == "cuda",
        obs=args.obs or bool(args.trace_out) or None))   # None: REPRO_OBS

    rng = np.random.default_rng(args.seed)
    t = 0.0
    for _ in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        eng.submit(Request(prompt_len=args.prompt, max_new_tokens=args.gen,
                           arrival_time=t), **frontend_inputs(cfg, rng))
    m = eng.run()
    s = eng.metrics_snapshot()
    where = (f"{torch.cuda.get_device_name(dev)} wall clock"
             if dev.type == "cuda" else "modelled clock, CPU run")
    print(f"arch={cfg.name} device={dev} ({where}) ws={not args.no_ws} "
          f"prefill={args.prefill} chunk={args.chunk} "
          f"obs={int(s['obs.enabled'])}")
    print(f"finished={m.num_finished}/{args.requests} "
          f"iters={s['engine.iterations']:.0f}")
    for st in eng.states.values():
        print(f"{st.req.req_id} prompt={st.req.prompt_len} "
              f"tokens={st.out_tokens}")
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
    overlap = eng.stage_overlap_measured()
    if overlap is not None:
        print(f"async host-stage overlap: {100*overlap:.1f}% of host-stage "
              f"work off-thread ({s['worker.jobs_run']:.0f} worker jobs)")
    if args.trace_out:
        n = eng.dump_trace(args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}")
    if args.prom:
        print(eng.metrics_prometheus(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
