#!/usr/bin/env python3
"""Time one source tree's redesigned kernels at the fp serve's shapes, under
chip_smoke.py's Timer with and without its ~0.1 ms device spin.

    python3 ab_kernels.py [--src DIR] [--seed 0] [--label NAME] [--probes]
                          [--shapes FILE ...] [--serves ARCH ...]

DIR is the ``src`` directory whose ``repro_torch`` is built and timed
(default: this checkout's).  Given the ``src`` of another checkout, for
example an earlier commit unpacked with ``git archive`` into a git-ignored
directory, it times that version's kernels with this checkout's timer, so
two versions can be compared in one call on one card (run them in the
order A, B, B, A).

Shapes: flash_prefill at the serve prefill's first launch (qwen2-0.5b,
B 1, Sq = Sk 4096, Hq 14, Hkv 2, D 64, q_offset 0), with SDPA on the same
inputs, and at llama3-8b's heads (B 1, Sq = Sk 2048, Hq 32, Hkv 8,
D 128), and, on inputs drawn from a generator of their own (seed + 1),
at MLA's q/k depth 96 with v width 64 (minicpm3-4b's 40 heads over 40)
and at D = Dv = 112 (kimi-k2's 64 heads over 8), B 1, 4096 tokens,
where the tree builds that instantiation, and each instantiation's
non-causal mode (a 1024-query window over 1500 keys, inputs from seed +
4); flash_prefill_bwd, where the tree has it, at the train phase's shape
(B 2, S 4096, Hq 14, Hkv 2, D 64) and llama3-8b's heads (B 1, S 2048,
32 over 8, D 128), inputs from seed + 5, its digest over dq, dk, dv,
its time and SDPA's backward's by CUDA events, and nvidia-smi's SM clock
and power draw, sampled every 100 ms while it runs back to back for ~3 s
(medians, extremes, the clock's maximum), and the training forward
(flash_prefill's lse instance) at the same two shapes, inputs from seed
+ 6, its digest over out and lse; and, where the tree builds them,
training's other instances, both the backward and the forward with lse,
on inputs from seed + 7: MLA's (96, 64) heads at minicpm3-4b's run (B 1,
S 4096, 40 over 40) and the non-causal mode at whisper-small's encoder
(B 8, 1500 x 1500, 12 heads of 64) and cross-attention (B 8, 448 x
1500), each beside SDPA's forward and backward;
sparse_decode_attention at
the serve's decode step (B 4, Hq 14, Hkv 2, NB 136, K 64, bs 32, D 64,
cur_len 4112, every selection valid: 512 live blocks, as the serve
replay has), and with the select stage at
the models phase's decode shapes of llama3-8b (B 1, Hq 32, Hkv 8,
NB 4104, D 128) and granite-20b (B 4, Hq 48, Hkv 1, NB 264, D 128);
block_score at the qwen2-0.5b step's
shape, and the decode select stage from q to the selected ids as the
tree's ``gqa_select_step`` runs it (``dsa.score_and_select``, the fused
``score_select`` launch, where the tree has it; else ``block_score`` then
``dsa.select_blocks``), the serve's DSA settings (K 64, one sink block,
two recent blocks); and one eviction round of the serve's size (296
blocks over 6 (request, layer) pairs of a 4-request, 24-layer decode
plane) as the tree's engine drops it (``drop_blocks_many``, one
``zero_blocks_hkv`` launch, where the tree has it; else one
``drop_blocks`` per pair); and one layer's int8 save as the tree's
engine runs it (``save_new_tokens_fused``, then ``flush_fused`` where
the tree has it, one ``quant_save_blocks`` launch; else each pool's
``flush``): a decode save (one float32 token for each of 4 requests, mid
block) and a prefill save (a 2048-token float32 chunk for each of 4
requests, 64 whole blocks each), into the int8 pools of a 24-layer
manager at the serve's widths.  And, on inputs drawn from a generator of
their own (seed + 2), the two recurrences at their serves' first prefill
launch and a decode launch: wkv6 at rwkv6-1.6b's (B 1, S 16,384 with
14,211 valid tokens from a zero state; B 4, S 1 from a carried one; 32
heads of 64) and selective_scan at jamba-v0.1-52b's (B 1, S 16,384 with
14,211 valid; B 4, S 1; d_inner 8192, d_state 16), each also timed with
CUDA events over back-to-back calls (``events_ms``) and under
torch.profiler (``device_ms``).  And training's recurrence kernels,
where the tree has them, on inputs drawn from a generator of their own
(seed + 8): kernel A (``wkv6_train_<case>``) and kernel B
(``wkv6_bwd_<case>``) at chip_smoke's WKV_TRAIN_CASES (train: B 2 x
4,096; ragged: B 2 x 1,000; prefill_window: B 1 x 14,211; 32 heads of
64), kernel C (``selective_scan_train_<case>``) and kernel D
(``selective_scan_bwd_<case>``) at its SCAN_TRAIN_CASES (train: B 1 x
4,096; ragged: B 2 x 1,000; prefill_window: B 1 x 14,211; d_inner
8192), each first held against its plain version under chip_smoke's
bars, then its time by CUDA events over back-to-back calls and a digest:
A's and C's over y, the final state and the chunks' states, B's and D's
over every gradient; B's and D's also device ms by kernel under
torch.profiler, and ``ptxas`` the two backwards' register and spill
lines.  The stages are timed with the host work
they carry; ``host_ms`` is their wall-clock time per call over 50 calls
ended by a synchronize, ``device_ms`` and ``device_ops`` their device
time and device operations per call under torch.profiler.  Each kernel
is held against its plain version with chip_smoke.py's tolerance first,
and its output's ``digest`` (sha1 of the bytes) is printed, so two trees'
kernels compare bit for bit on the same inputs.
With ``--shapes``, files that chip_smoke.py's models phase writes
(chiprun_out/launch_shapes_<tag>_<arch>.json: a recurrence's launches of
one serve by (B, S)): each shape is timed on the tree's kernel (device
ms under torch.profiler, inputs from seed + 3, every position valid) and
the serve's device time in that kernel is summed over its launches.
With ``--probes``, the card's rates for what bounds the scan: MUFU.EX2
(``ex2.approx``), expf's whole sequence and FFMA, each over 8 independent
chains a thread in 8 CTAs of 256 threads an SM, per SM and microsecond,
from a probe kernel built here with nvcc; and wkv6's decode launch through
its step kernel and through its window kernel (built here on the tree's
csrc/wkv6.cu), device ms of each; and flash_prefill_bwd at its two
shapes as the tree builds it and built with -DFLASH_BWD_PRODUCTS_ONLY
(the products without the masking, exponentials and dS between them;
its results are not the gradient), CUDA events over back-to-back
launches of each and device ms by kernel; and kernels B and D at their
train shapes built with each probe switch their source knows
(SCAN_BWD_PROBES: -DWKV_BWD_NO_STORES, -DSCAN_BWD_NO_EXP,
-DSCAN_BWD_NO_STORES; results not the gradient) beside the whole.
With ``--serves ARCH ...``, chip_smoke's models-phase serve of each arch
on the tree's engine, on the modelled clock and on the wall clock: a
digest of the greedy tokens, so two trees' tokens compare in one call.
With ``--profile``, chip_smoke's profile phase then serves on the tree's
engine under torch.profiler, with the fp tier and then with the int8
tier (idle share, count of device operations, the port's kernels, a
digest of the tokens served), so two trees' launch counts compare in one
call.  Prints one JSON line last; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def _host_ms(torch, fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _device_ms(torch, fn, reps: int = 20) -> tuple:
    """(device ms, device operations) per call of ``fn``: torch.profiler
    over ``reps`` calls, the device-side events (kernels, copies, memsets)
    summed, so a stage's time on the card is read apart from the host
    time that enqueues it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in rows)
    return us / 1e3 / reps, sum(e.count for e in rows) / reps


def _drop_plane(torch, gen, dev, n_req: int, n_layers: int, nb: int):
    """A decode plane of ``n_req`` requests at the serve's widths (Hkv 2,
    bs 32, D 64, bf16 pools), ``nb`` written blocks each."""
    from repro_torch.configs import get_config
    from repro_torch.core.device_pool import DevicePoolPlane
    plane = DevicePoolPlane(get_config("qwen2-0.5b"))
    for r in range(n_req):
        caches = [{"k": torch.randn((1, 2, nb, 32, 64), generator=gen,
                                    device=dev).bfloat16(),
                   "v": torch.randn((1, 2, nb, 32, 64), generator=gen,
                                    device=dev).bfloat16(),
                   "meta": torch.zeros((1, 2, nb, 2, 64), device=dev)}
                  for _ in range(n_layers)]
        plane.admit(f"r{r}", {"caches": caches,
                              "cur_len": torch.tensor([nb * 32],
                                                      dtype=torch.int32),
                              "extra": {}})
    return plane


def _int8_save(torch, gen, dev, T: int):
    """One layer's int8 save of 4 requests at the serve's widths, as this
    tree's engine runs it: a function that stages T tokens per request
    (T == 1: (Hkv, 1, D) views of a (4, Hkv, D) decode stripe at token
    4112; else (Hkv, T, D) views of a (T, Hkv, D) prefill chunk from
    token 0; float32, as the engine ships both) into layer 5 of a 24-layer int8 manager and
    flushes them."""
    from repro_torch.core.kv_cache import KVCacheManager, KVGeometry
    mgr = KVCacheManager(KVGeometry(24, 2, 32, 64), 1 << 30,
                         offload_quant="int8", device=dev)
    rids = [f"r{i}" for i in range(4)]
    for rid in rids:
        mgr.register(rid, 4096 + 32, 96)
    if T == 1:
        k, v = (torch.randn((4, 2, 64), generator=gen, device=dev)
                for _ in range(2))
        kv = {rid: (4112, k[i][:, None, :], v[i][:, None, :])
              for i, rid in enumerate(rids)}
    else:
        k, v = (torch.randn((4, T, 2, 64), generator=gen, device=dev)
                for _ in range(2))
        kv = {rid: (0, k[i].permute(1, 0, 2), v[i].permute(1, 0, 2))
              for i, rid in enumerate(rids)}
    fused = hasattr(mgr, "flush_fused")

    def save():
        mgr.save_new_tokens_fused(5, kv)
        if fused:
            mgr.flush_fused(5, rids)
        else:
            for rid in rids:
                mgr.pools[rid].flush()
    return save, ("flush_fused" if fused else "per-pool flush")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    ap.add_argument("--shapes", nargs="*", default=[],
                    help="launch_shapes JSON files of chip_smoke's models "
                         "phase: the serve's device ms in each recurrence")
    ap.add_argument("--probes", action="store_true",
                    help="the card's MUFU.EX2, expf and FFMA rates")
    ap.add_argument("--profile", action="store_true",
                    help="then chip_smoke's profile phase on this tree's "
                         "engine: idle share, device operations, the "
                         "port's kernels")
    ap.add_argument("--serves", nargs="*", default=[],
                    help="archs of chip_smoke's models phase: the greedy "
                         "tokens of this tree's serve")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.core import dsa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import LIBS
    from repro_torch.models.common import DSAConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    LIBS.build()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    Hq, Hkv, D, bs, K, B = 14, 2, 64, 32, 64, 4
    S = cs.SERVE_PROMPT
    cur = S + cs.SERVE_NEW // 2
    NB = -(-(S + cs.SERVE_NEW) // bs) + 7
    q = randn(B, Hq, D)
    k_pool, v_pool = randn(B, Hkv, NB, bs, D), randn(B, Hkv, NB, bs, D)
    live = -(-cur // bs)
    pick = torch.rand((B, Hkv, live), generator=gen, device=dev)
    idx = pick.argsort(dim=-1)[..., :K].to(torch.int32).contiguous()
    valid = torch.ones((B, Hkv, K), dtype=torch.bool, device=dev)
    cur_len = torch.full((B,), cur, dtype=torch.int32, device=dev)
    fq, fk, fv = randn(1, S, Hq, D), randn(1, S, Hkv, D), randn(1, S, Hkv, D)
    wq, wk, wv = (randn(1, S // 2, 32, 128), randn(1, S // 2, 8, 128),
                  randn(1, S // 2, 8, 128))
    mn = torch.randn((B, Hkv, NB, D), generator=gen, device=dev)
    meta = torch.stack([mn, mn + torch.rand((B, Hkv, NB, D), generator=gen,
                                            device=dev)], dim=3).contiguous()
    cases = {
        "sparse_decode_attention": cs.case_attention(
            torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len),
        "flash_prefill": cs.case_flash(torch, ops, ref, fq, fk, fv,
                                       scale=D ** -0.5),
        "flash_prefill_d128": cs.case_flash(torch, ops, ref, wq, wk, wv,
                                            scale=128 ** -0.5),
        "block_score": cs.case_score(torch, ops, ref, q, meta),
    }
    # flash_prefill's other instantiations, on inputs of their own, so
    # that the cases above and below keep theirs
    gen2 = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for name, (hq, hkv, dq, dv) in {"flash_prefill_mla": (40, 40, 96, 64),
                                    "flash_prefill_d112": (64, 8, 112,
                                                           112)}.items():
        fx = [torch.randn((1, S, h, d), generator=gen2, device=dev).to(
            torch.bfloat16) for h, d in ((hq, dq), (hkv, dq), (hkv, dv))]
        if (dq, dv) in getattr(ops, "FLASH_DIMS", ()):
            cases[name] = cs.case_flash(torch, ops, ref, *fx,
                                        scale=dq ** -0.5)
    # every instantiation's non-causal mode (Whisper's), on inputs of
    # their own: a 1024-query window over 1500 keys (a ragged last tile)
    gen4 = torch.Generator(device=dev).manual_seed(args.seed + 4)
    for name, (hq, hkv, dq, dv) in {
            "flash_prefill_nc_d64": (14, 2, 64, 64),
            "flash_prefill_nc_d128": (32, 8, 128, 128),
            "flash_prefill_nc_mla": (40, 40, 96, 64),
            "flash_prefill_nc_d112": (64, 8, 112, 112)}.items():
        fx = [torch.randn((1, n, h, d), generator=gen4, device=dev).to(
            torch.bfloat16) for n, h, d in ((1024, hq, dq), (1500, hkv, dq),
                                            (1500, hkv, dv))]
        if (dq, dv) in getattr(ops, "FLASH_DIMS", ()):
            cases[name] = cs.case_flash(torch, ops, ref, *fx,
                                        scale=dq ** -0.5, causal=False)
    # training's backward at the train phase's shape and llama3-8b's
    # heads, on inputs of their own, where the tree has it
    gen5 = torch.Generator(device=dev).manual_seed(args.seed + 5)
    if hasattr(ops, "flash_prefill_bwd"):
        for name, (b, n, hq, hkv, d) in {
                "flash_prefill_bwd": (2, 4096, 14, 2, 64),
                "flash_prefill_bwd_d128": (1, 2048, 32, 8, 128)}.items():
            bx = [torch.randn((b, n, h, d), generator=gen5, device=dev).to(
                torch.bfloat16) for h in (hq, hkv, hkv, hq)]
            cases[name] = cs.case_flash_bwd(torch, ops, ref, *bx,
                                            d ** -0.5)
    # the training forward (flash_prefill's lse instance) at the same
    # shapes, on inputs of their own: its digest covers out and lse
    gen6 = torch.Generator(device=dev).manual_seed(args.seed + 6)
    if hasattr(ops, "flash_prefill_fwd_lse"):
        for name, (b, n, hq, hkv, d) in {
                "flash_prefill_lse": (2, 4096, 14, 2, 64),
                "flash_prefill_lse_d128": (1, 2048, 32, 8, 128)}.items():
            lx = [torch.randn((b, n, h, d), generator=gen6, device=dev).to(
                torch.bfloat16) for h in (hq, hkv, hkv)]
            cases[name] = cs.case_flash_lse(torch, ops, ref, *lx, d ** -0.5)
    # training's instances beside them, where the tree builds them: MLA's
    # (96, 64) heads at minicpm3-4b's run (B 1, S 4096, 40 over 40) and
    # the non-causal mode at whisper-small's encoder (B 8, 1500 x 1500)
    # and cross-attention (448 x 1500), 12 heads of 64, inputs from
    # seed + 7: the backward and the forward with lse
    gen7 = torch.Generator(device=dev).manual_seed(args.seed + 7)
    if (96, 64) in getattr(ops, "FLASH_BWD_DIMS", ()):
        for tag, (b, sq, sk, h, d, dv, causal) in {
                "mla": (1, 4096, 4096, 40, 96, 64, True),
                "nc_encoder": (8, 1500, 1500, 12, 64, 64, False),
                "nc_cross": (8, 448, 1500, 12, 64, 64, False)}.items():
            tq, tk, tv, tdo = [torch.randn(shape, generator=gen7,
                                           device=dev).to(torch.bfloat16)
                               for shape in ((b, sq, h, d), (b, sk, h, d),
                                             (b, sk, h, dv), (b, sq, h, dv))]
            cases[f"flash_prefill_bwd_{tag}"] = cs.case_flash_bwd(
                torch, ops, ref, tq, tk, tv, tdo, d ** -0.5, causal)
            cases[f"flash_prefill_lse_{tag}"] = cs.case_flash_lse(
                torch, ops, ref, tq, tk, tv, d ** -0.5, causal)
    # the two recurrences at their serves' first prefill and a decode
    # launch, on inputs of their own
    gen3 = torch.Generator(device=dev).manual_seed(args.seed + 2)
    recurrences = {
        "wkv6_prefill": cs.case_wkv(torch, ops, ref, *cs._wkv_inputs(
            torch, gen3, 1, 16384, (14211,), False)),
        "wkv6_decode": cs.case_wkv(torch, ops, ref, *cs._wkv_inputs(
            torch, gen3, 4, 1, (1,) * 4, True)),
        "selective_scan_prefill": cs.case_scan(
            torch, ops, ref, *cs._scan_inputs(torch, gen3, 1, 16384,
                                              (14211,))),
        "selective_scan_decode": cs.case_scan(
            torch, ops, ref, *cs._scan_inputs(torch, gen3, 4, 1, (1,) * 4)),
    }
    cases.update(recurrences)
    # training's recurrence kernels A-D at the train phase's cases, on
    # inputs of their own
    train = _train_recurrences(torch, cs, ops, ref, dev, args.seed)
    # the decode select stage, as this tree's gqa_select_step runs it, on
    # the cache before the step's append (before + 1 = cur_len tokens)
    cfg = DSAConfig()
    fused = hasattr(dsa, "score_and_select")

    def select_stage(q, meta, cur_len):
        before = cur_len - 1
        if fused:
            stage = lambda: dsa.score_and_select(q, meta, cfg, before)
        else:
            stage = lambda: dsa.select_blocks(
                dsa.score_blocks(q, meta, cfg.metadata), cfg, before + 1)
        scores = ref.block_score(q, meta)
        ok, err = cs.select_agrees(
            torch, stage(), dsa.select_blocks(scores, cfg, before + 1),
            _select_scores(torch, scores, before + 1, cfg))
        if not ok:
            raise AssertionError(f"select stage disagrees with the plain "
                                 f"one ({err})")
        return stage

    stage = select_stage(q, meta, cur_len)
    select_stages = {}
    # the models phase's GQA decode shapes: (B, Hq, Hkv, NB), D 128
    for tag, (b, hq, hkv, nb) in {"llama3": (1, 32, 8, 4104),
                                  "granite": (4, 48, 1, 264)}.items():
        g_cur = torch.full((b,), (nb - 7) * bs - bs // 2, dtype=torch.int32,
                           device=dev)
        g_q = randn(b, hq, 128)
        g_pool = [randn(b, hkv, nb, bs, 128) for _ in range(2)]
        g_pick = torch.rand((b, hkv, nb - 7), generator=gen, device=dev)
        g_idx = g_pick.argsort(dim=-1)[..., :K].to(torch.int32).contiguous()
        g_mn = torch.randn((b, hkv, nb, 128), generator=gen, device=dev)
        g_meta = torch.stack([g_mn, g_mn + torch.rand(
            (b, hkv, nb, 128), generator=gen, device=dev)], dim=3)
        cases[f"sparse_decode_attention_{tag}"] = cs.case_attention(
            torch, ops, ref, g_q, *g_pool, g_idx,
            torch.ones((b, hkv, K), dtype=torch.bool, device=dev), g_cur)
        select_stages[f"select_stage_{tag}"] = select_stage(
            g_q, g_meta.contiguous(), g_cur)
    # one eviction round of the serve's size
    plane = _drop_plane(torch, gen, dev, 4, 24, 129)
    rng = np.random.default_rng(args.seed)
    pairs = [(f"r{r}", int(l)) for r, l in zip(
        rng.integers(0, 4, 6), rng.choice(24, 6, replace=False))]
    round_ = {pair: sorted(rng.choice(129, n, replace=False).tolist())
              for pair, n in zip(pairs, (50, 50, 49, 49, 49, 49))}
    if hasattr(plane, "drop_blocks_many"):
        drop = lambda: plane.drop_blocks_many(round_)
    else:
        def drop():
            for (rid, layer), blks in round_.items():
                plane.drop_blocks(rid, layer, blks)
    drop()
    torch.cuda.synchronize()
    for (rid, layer), blks in round_.items():
        c = plane.state["caches"][layer]
        row = plane.rows[rid]
        if c["k"][row, :, blks].any() or c["v"][row, :, blks].any():
            raise AssertionError("drop round left data in a dropped block")
    stages = {"select_stage": (stage, "fused score_select" if fused
                               else "block_score + dsa.select_blocks"),
              "drop_round": (drop, "drop_blocks_many" if hasattr(
                  plane, "drop_blocks_many") else "drop_blocks per pair"),
              "int8_decode_save": _int8_save(torch, gen, dev, 1),
              "int8_prefill_save": _int8_save(torch, gen, dev, 2048)}
    stages.update({name: (fn, stages["select_stage"][1])
                   for name, fn in select_stages.items()})

    timers = {"spin": cs.Timer(torch), "no_spin": cs.Timer(torch,
                                                           spin=False)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out = {"label": args.label, "src": args.src,
           "card": smi.stdout.strip().splitlines()[0]}
    for name, case in cases.items():
        err, ok, kern, _plain, nbytes, nops, shape = case[:7]
        if not ok:
            raise AssertionError(f"{name}: outside the tolerance ({err})")
        rec = {"shape": shape, "max_abs_err": err,
               "bound_ms": cs.bound_ms(nbytes, nops)[0],
               "digest": _digest(torch, kern())}
        for tname, timer in timers.items():
            rec[f"ms_{tname}"] = timer(kern)
            if len(case) > 7 and case[7] is not None:
                rec[f"library_ms_{tname}"] = timer(case[7])
        if name in recurrences or name.startswith("flash_prefill_bwd"):
            rec["events_ms"] = cs.events_ms(torch, kern)
            rec["device_ms"] = cs.device_ms(torch, kern)
        if name.startswith("flash_prefill_bwd"):
            rec["digests_dq_dk_dv"] = [_digest(torch, t) for t in kern()]
            if case[7] is not None:   # SDPA's backward, by CUDA events
                rec["library_events_ms"] = cs.events_ms(torch, case[7])
            rec["power"] = _power(torch, cs, kern)
        out[name] = rec
    for name, (digest_of, kern, nbytes, nops, shape, split) in (
            train.items()):
        rec = {"shape": shape, "bound_ms": cs.bound_ms(nbytes, nops)[0],
               "digest": digest_of(kern()),
               "events_ms": cs.events_ms(torch, kern)}
        if split:
            rec["device_ms_by_kernel"] = cs.device_ms(torch, kern,
                                                      by_kernel=split)
        out[name] = rec
    for name, (fn, how) in stages.items():
        rec = {"how": how}
        if name.startswith("select_stage"):
            rec["digest"] = _digest(torch, fn())
        for tname, timer in timers.items():
            ops.launches.reset()
            rec[f"ms_{tname}"] = timer(fn)
            # launches of one call (the Timer makes 21)
            rec["launches_per_call"] = {
                k: c / 21 for k, c in ops.launches.snapshot().items() if c}
        rec["host_ms"] = _host_ms(torch, fn)
        rec["device_ms"], rec["device_ops"] = _device_ms(torch, fn)
        out[name] = rec
    out["drop_round"]["blocks"] = sum(len(b) for b in round_.values())
    out["ptxas"] = {name: [line.split("ptxas info    : ")[-1].strip()
                           for line in ops.LIBS.ptxas_info[name].splitlines()
                           if "registers" in line or "spill" in line]
                    for name in ("wkv6_bwd", "selective_scan_bwd")
                    if name in ops.LIBS.ptxas_info}
    del plane, cases, stages, recurrences, train
    if args.shapes:
        out["serve_sums"] = _serve_sums(torch, cs, ops, dev, args.shapes,
                                        args.seed)
    if args.probes:
        out["probes"] = _probes(torch, dev)
        out["probes"].update(_emit_probe(torch, cs, ops, dev, args.seed))
        out["probes"].update(_bwd_products_probe(torch, cs, ops, dev,
                                                 args.seed))
        out["probes"].update(_scan_bwd_probes(torch, cs, ops, dev,
                                              args.seed))
    if args.serves:
        out["serves"] = {arch: _serve_tokens(torch, np, cs, arch, args.seed)
                         for arch in args.serves}
    if args.profile:
        cs.phase_profile(torch, np, args.seed)
        cs.phase_profile(torch, np, args.seed, "int8")
    print(json.dumps(out))
    return 0


def _power(torch, cs, fn, seconds: float = 3.0) -> dict:
    """The card while ``fn`` runs back to back for ~``seconds``:
    nvidia-smi's SM clock and power draw every 100 ms (the first and last
    samples dropped), their medians and extremes, and the clock's
    maximum."""
    query = ["nvidia-smi", "--format=csv,noheader,nounits"]
    top = subprocess.run(query + ["--query-gpu=clocks.max.sm"],
                         capture_output=True, text=True).stdout.split()
    reps = max(1, int(seconds * 1e3 / cs.events_ms(torch, fn)))
    smi = subprocess.Popen(query + ["--query-gpu=clocks.sm,power.draw",
                                    "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    rows = [[float(x) for x in line.split(",")]
            for line in smi.communicate()[0].splitlines() if line.strip()]
    clk, watts = (sorted(r[i] for r in rows[3:-2]) for i in (0, 1))
    if not clk:
        return {"samples": 0}
    return {"samples": len(clk), "sm_mhz_median": clk[len(clk) // 2],
            "sm_mhz_min": clk[0], "sm_mhz_max_clock": top[0] if top else None,
            "power_w_median": watts[len(watts) // 2],
            "power_w_max": watts[-1]}


def _serve_tokens(torch, np, cs, arch: str, seed: int) -> dict:
    """chip_smoke's models-phase serve of ``arch`` on this tree (its
    weights from ``seed``, its submissions and layer cut, the engine's
    default tier), once on the modelled clock, where two trees run the
    same schedule, and once charging the wall clock as the models phase
    does.  For each: sha1 of the greedy tokens in submission order, the
    iterations by their decode rows, and the mean TTFT."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_config(arch)
    if arch in cs.MODEL_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=cs.MODEL_LAYERS[arch])
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), torch.bfloat16, "cuda")
    res = {}
    for clock, real in (("modelled", False), ("wall", True)):
        subs = cs._model_submissions(np, Request, cfg, arch, seed)
        budget, _ = cs._hbm_budget(torch, cfg, subs,
                                   EngineConfig().hbm_budget_bytes)
        eng = ServingEngine(params, cfg, EngineConfig(
            seed=seed, charge_real_time=real, hbm_budget_bytes=budget))
        for r, toks, extra in subs:
            eng.submit(r, tokens=toks, **extra)
        m = eng.run()
        tokens = json.dumps([eng.states[r.req_id].out_tokens
                             for r, _, _ in subs])
        rows = {}
        for e in eng.mixed_iter_log:
            if e["decode_rows"]:
                rows[e["decode_rows"]] = rows.get(e["decode_rows"], 0) + 1
        eng.close()
        res[clock] = {"tokens_sha1":
                      hashlib.sha1(tokens.encode()).hexdigest()[:16],
                      "decode_iterations_by_rows": rows,
                      "mean_ttft_ms": m.mean_ttft * 1e3}
    return res


def _serve_sums(torch, cs, ops, dev, files, seed: int) -> dict:
    """{kernel:arch: {"shapes": {BxS: {launches, device_ms}}, "summed_ms"}}:
    each launch shape of a serve timed on this tree's kernel (device ms
    under torch.profiler), and their sum over the serve's launches."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    res = {}
    for f in files:
        d = json.loads(Path(f).read_text())
        per, total = {}, 0.0
        for shape, n in sorted(d["shapes"].items()):
            Bn, S = map(int, shape.split("x"))
            if d["kernel"] == "wkv6":
                a = cs._wkv_inputs(torch, gen, Bn, S, (S,) * Bn, True)
                fn = lambda: ops.wkv6(*a)  # noqa: E731
            else:
                a = cs._scan_inputs(torch, gen, Bn, S, (S,) * Bn)
                fn = lambda: ops.selective_scan(*a)  # noqa: E731
            ms = cs.device_ms(torch, fn)
            per[shape] = {"launches": n, "device_ms": ms}
            total += n * ms
        res[f"{d['kernel']}:{d['arch']}"] = {"shapes": per,
                                             "summed_ms": total}
    return res


_PROBE_SRC = r"""
#include <cuda_runtime.h>
template <int kMode>
__global__ void probe(float* out, int iters) {
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = -1e-3f * (threadIdx.x + k);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (kMode == 0) {
        float e;
        asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v[k]));
        v[k] = -0.5f * e;
      } else if (kMode == 1) {
        v[k] = -0.5f * expf(v[k]);
      } else {
        v[k] = fmaf(v[k], 0.999f, -0.001f);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += v[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int launch_probe(int mode, void* out, int blocks, int threads,
                            int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (mode == 0) probe<0><<<blocks, threads, 0, s>>>(o, iters);
  else if (mode == 1) probe<1><<<blocks, threads, 0, s>>>(o, iters);
  else probe<2><<<blocks, threads, 0, s>>>(o, iters);
  return (int)cudaGetLastError();
}
"""


def _probes(torch, dev) -> dict:
    """Results per SM and microsecond of MUFU.EX2 (each with one FMUL),
    expf (its eight instructions and one FMUL) and FFMA, 8 independent
    chains a thread, 8 CTAs of 256 threads an SM, CUDA events over 5
    launches (the third of three readings), with the SM clock nvidia-smi
    reads after them."""
    import ctypes
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "rate_probe.cu"
    lib = build.BUILD_DIR / "librate_probe.so"
    src.write_text(_PROBE_SRC)
    subprocess.run([build.nvcc_path()] + build.NVCC_FLAGS
                   + ["-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).launch_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = 8 * sms, 256, 4096
    buf = torch.empty(blocks * threads, device=dev)
    import chip_smoke as cs
    res = {}
    for mode, what in ((0, "ex2_approx"), (1, "expf"), (2, "ffma")):
        def call():
            if fn(mode, buf.data_ptr(), blocks, threads, iters,
                  torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError("rate probe launch failed")
        for _ in range(3):
            ms = cs.events_ms(torch, call, 5)
        res[f"{what}_per_sm_per_us"] = (blocks * threads * iters * 8 / ms
                                        / 1e3 / sms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    res["clocks_sm_mhz_after"] = smi.stdout.strip()
    return res


_EMIT_PROBE_SRC = r"""
#include "wkv6.cu"
// wkv6_emit_kernel alone on a window of S tokens from s0 (one pass, as
// launch_wkv6 runs a window of at most one chunk), whatever S is
extern "C" int launch_wkv6_emit(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* y, void* s_out, int B, int S, int H,
                                void* stream) {
  wkv6_emit_kernel<<<dim3(1, H, B), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H, S, 1);
  return (int)cudaGetLastError();
}
"""


def _emit_probe(torch, cs, ops, dev, seed: int) -> dict:
    """wkv6's decode launch (B 4, S 1, rwkv6-1.6b's 32 heads) as the
    tree's wrapper runs it (wkv6_step_kernel) and through the window
    kernel (wkv6_emit_kernel, built here on the tree's wkv6.cu): device
    ms of each under torch.profiler and their largest difference; {}
    where the tree has no window kernel."""
    import ctypes
    from repro_torch.kernels import build
    if "wkv6_emit_kernel" not in (build.CSRC_DIR / "wkv6.cu").read_text():
        return {}
    src = build.BUILD_DIR / "wkv6_emit_probe.cu"
    lib = build.BUILD_DIR / "libwkv6_emit_probe.so"
    src.write_text(_EMIT_PROBE_SRC)
    subprocess.run([build.nvcc_path()] + build.NVCC_FLAGS
                   + ["-I", str(build.CSRC_DIR), "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).launch_wkv6_emit
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    r, k, v, w, u, S0 = cs._wkv_inputs(torch, gen, 4, 1, (1,) * 4, True)
    y = torch.empty((4, 1, 32, 64), dtype=torch.float32, device=dev)
    s_out = torch.empty_like(S0)

    def emit():
        if fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
              u.data_ptr(), S0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
              4, 1, 32, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("wkv6 emit probe launch failed")

    step = lambda: ops.wkv6(r, k, v, w, u, S0)  # noqa: E731
    y_step, s_step = step()
    emit()
    torch.cuda.synchronize()
    return {"wkv6_decode_step_kernel_device_ms": cs.device_ms(torch, step),
            "wkv6_decode_emit_kernel_device_ms": cs.device_ms(torch, emit),
            "wkv6_decode_step_vs_emit_max_abs_diff": max(
                (y - y_step).abs().max().item(),
                (s_out - s_step).abs().max().item())}


def _bwd_products_probe(torch, cs, ops, dev, seed: int) -> dict:
    """flash_prefill_bwd's kernels at the train phase's shape and
    llama3-8b's heads, launched through the tree's library and through one
    built here on the tree's flash_prefill_bwd.cu with
    -DFLASH_BWD_PRODUCTS_ONLY, on the same inputs and buffers: CUDA events
    over back-to-back launches (the better of three readings) and device
    ms by kernel under torch.profiler, with the 5-product bound and the
    design's 7-product floor.  {} where the tree's source has no such
    build."""
    import ctypes
    from repro_torch.kernels import build
    src = build.CSRC_DIR / "flash_prefill_bwd.cu"
    if "FLASH_BWD_PRODUCTS_ONLY" not in src.read_text():
        return {}
    lib = build.BUILD_DIR / "libflash_prefill_bwd_products.so"
    subprocess.run([build.nvcc_path()] + build.NVCC_FLAGS
                   + ["-DFLASH_BWD_PRODUCTS_ONLY", "-I", str(build.CSRC_DIR),
                      "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    _, sym, argtypes = build._SIGNATURES["flash_prefill_bwd"]
    products = getattr(ctypes.CDLL(str(lib)), sym)
    products.argtypes, products.restype = argtypes, ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    res = {}
    for name, (b, n, hq, hkv, d) in {
            "train": (2, 4096, 14, 2, 64),
            "llama3_8b": (1, 2048, 32, 8, 128)}.items():
        q, k, v, do = [torch.randn((b, n, h, d), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq)]
        o, lse = ops.flash_prefill_fwd_lse(q, k, v, scale=d ** -0.5)
        # (B, Sq, Sk, Hq, Hkv, D, Dv), then causal
        dims = (b, n, n, hq, hkv, d, d)
        ws_n = ops.LIBS.fn("flash_prefill_bwd_ws")(*dims)
        ws = torch.empty(ws_n, dtype=torch.float32, device=dev)
        grads = [torch.empty(t.shape, dtype=torch.float32, device=dev)
                 for t in (q, k, v)]

        def call(fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), ws.data_ptr(), ws_n,
                    *[g.data_ptr() for g in grads], *dims, 1,
                    d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"flash_prefill_bwd launch failed ({rc})")

        pairs = n * (n + 1) // 2
        bound = cs.bound_ms(0, 10 * d * pairs * hq * b)[0]
        rec = {"flop_bound_ms": bound, "floor_7_products_ms": bound * 7 / 5}
        for tag, fn in (("whole", ops.LIBS.fn("flash_prefill_bwd")),
                        ("products_only", products)):
            rec[f"{tag}_events_ms"] = min(
                cs.events_ms(torch, lambda: call(fn), 20) for _ in range(3))
            rec[f"{tag}_device_ms_by_kernel"] = cs.device_ms(
                torch, lambda: call(fn), by_kernel="flash_bwd_")
        res[f"flash_prefill_bwd_products_{name}"] = rec
    return res


def _train_recurrences(torch, cs, ops, ref, dev, seed: int) -> dict:
    """Training's recurrence kernels where the tree has them: kernel A
    (``wkv6_train``) and B (``wkv6_bwd``) at chip_smoke's
    WKV_TRAIN_CASES, kernel C (``selective_scan_train``) and D
    (``selective_scan_bwd``) at its SCAN_TRAIN_CASES, on inputs drawn in
    that order from one generator of their own (seed + 8).  Each is held
    against its plain version under chip_smoke's bars first (B and D
    without their planted faults).  name -> (digest function, kernel
    call, bytes, operations, shape, kernel-name prefix for the profiler's
    split or "")."""
    if not hasattr(ops, "wkv6_bwd") or not hasattr(ops,
                                                   "selective_scan_bwd"):
        return {}
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    res = {}

    def tag(label):
        return label.split("=")[1]

    def add(name, case, split=""):
        err, ok, kern, _plain, nbytes, nops, shape = case[:7]
        if not ok:
            raise AssertionError(f"{name}: outside the bar ({err})")
        res[name] = (lambda t: _digest(torch, tuple(t)), kern, nbytes, nops,
                     shape, split)
    for label, Bn, S, lens in cs.WKV_TRAIN_CASES:
        args = cs._wkv_train_inputs(torch, gen, Bn, S, lens)
        add(f"wkv6_train_{tag(label)}",
            cs.case_wkv_train(torch, ops, ref, *args[:6]))
        add(f"wkv6_bwd_{tag(label)}",
            cs.case_wkv_bwd(torch, ops, ref, *args, label, faults=False),
            "wkv6_bwd")
    for label, Bn, S, lens in cs.SCAN_TRAIN_CASES:
        args = cs._scan_train_inputs(torch, gen, Bn, S, lens)
        add(f"selective_scan_train_{tag(label)}",
            cs.case_scan_train(torch, ops, ref, *args[:7]))
        add(f"selective_scan_bwd_{tag(label)}",
            cs.case_scan_bwd(torch, ops, ref, *args, label, faults=False),
            "selective_scan_bwd")
    return res


# the backwards' probe builds: (wrapper name, source, -D flag)
SCAN_BWD_PROBES = (("wkv6_bwd", "wkv6_bwd.cu", "WKV_BWD_NO_STORES"),
                   ("selective_scan_bwd", "selective_scan_bwd.cu",
                    "SCAN_BWD_NO_EXP"),
                   ("selective_scan_bwd", "selective_scan_bwd.cu",
                    "SCAN_BWD_NO_STORES"))


def _scan_bwd_probes(torch, cs, ops, dev, seed: int) -> dict:
    """Kernels B and D at their train cases' first (path=train) shape,
    launched through the tree's library and through one built here on the
    tree's source with each probe flag of SCAN_BWD_PROBES that the source
    knows (its results are not the gradient): CUDA events over
    back-to-back calls of the wrapper, the better of three readings each,
    and device ms by kernel under torch.profiler."""
    import ctypes
    from repro_torch.kernels import build
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    _, Bn, S, lens = cs.WKV_TRAIN_CASES[0]
    r, k, v, w, u, S0, dy, dS = cs._wkv_train_inputs(torch, gen, Bn, S,
                                                     lens)
    S_in = ops.wkv6_train(r, k, v, w, u, S0)[2]
    _, Bn, S, lens = cs.SCAN_TRAIN_CASES[0]
    x, dt, B, C, A, D, h0, sdy, dh = cs._scan_train_inputs(torch, gen, Bn,
                                                           S, lens)
    ckpt = ops.selective_scan_train(x, dt, B, C, A, D, h0)[2]
    calls = {"wkv6_bwd": lambda: ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS),
             "selective_scan_bwd": lambda: ops.selective_scan_bwd(
                 x, dt, B, C, A, D, ckpt, sdy, dh)}
    res = {}
    for name, src_name, flag in SCAN_BWD_PROBES:
        src = build.CSRC_DIR / src_name
        if flag not in src.read_text():
            continue
        lib = build.BUILD_DIR / f"lib{name}_{flag.lower()}.so"
        subprocess.run([build.nvcc_path()] + build.NVCC_FLAGS
                       + [f"-D{flag}", "-I", str(build.CSRC_DIR), "-o",
                          str(lib), str(src)], check=True,
                       capture_output=True)
        _, sym, argtypes = build._SIGNATURES[name][:3]
        probe = getattr(ctypes.CDLL(str(lib)), sym)
        probe.argtypes, probe.restype = argtypes, ctypes.c_int
        whole = ops.LIBS.fn(name)
        rec = {}
        for what, fn in (("whole", whole), (flag.lower(), probe)):
            ops.LIBS._fns[name] = fn
            try:
                rec[f"{what}_events_ms"] = min(
                    cs.events_ms(torch, calls[name]) for _ in range(3))
                rec[f"{what}_device_ms_by_kernel"] = cs.device_ms(
                    torch, calls[name], by_kernel=name)
            finally:
                ops.LIBS._fns[name] = whole
        res[f"{name}_{flag.lower()}"] = rec
    return res


def _digest(torch, res) -> str:
    """sha1 of the bytes of a kernel's output (a tensor, or a tuple of
    them as a select returns)."""
    torch.cuda.synchronize()
    h = hashlib.sha1()
    for t in (res if isinstance(res, tuple) else (res,)):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _select_scores(torch, scores, n_tokens, cfg):
    """The scores the DSA top-k ranks, as the reference's ``select_blocks``
    builds them: blocks at or past ceil(n_tokens / bs) masked to -1e30,
    the valid sink and recent blocks forced to +inf (built here, so the
    check does not depend on the timed tree's plain versions)."""
    NB = scores.shape[-1]
    blk = torch.arange(NB, device=scores.device)
    n_valid = torch.ceil(n_tokens.float() / cfg.block_size).long()
    valid = blk[None] < n_valid[:, None]
    force = valid & ((blk[None] < n_valid.clamp(max=cfg.sink_blocks)[:, None])
                     | ((blk[None] >= (n_valid - cfg.recent_blocks)[:, None])
                        & (cfg.recent_blocks > 0)))
    s = torch.where(valid[:, None], scores, -1e30)
    return torch.where(force[:, None], float("inf"), s)


if __name__ == "__main__":
    sys.exit(main())
