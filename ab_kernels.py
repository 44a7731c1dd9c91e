#!/usr/bin/env python3
"""Time one source tree's redesigned kernels at the fp serve's shapes, under
chip_smoke.py's Timer with and without its ~0.1 ms device spin.

    python3 ab_kernels.py [--src DIR] [--seed 0] [--label NAME]

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
where the tree builds that instantiation; sparse_decode_attention at
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
manager at the serve's widths.  The stages are timed with the host work
they carry; ``host_ms`` is their wall-clock time per call over 50 calls
ended by a synchronize, ``device_ms`` and ``device_ops`` their device
time and device operations per call under torch.profiler.  Each kernel
is held against its plain version with chip_smoke.py's tolerance first,
and its output's ``digest`` (sha1 of the bytes) is printed, so two trees'
kernels compare bit for bit on the same inputs.
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
    ap.add_argument("--profile", action="store_true",
                    help="then chip_smoke's profile phase on this tree's "
                         "engine: idle share, device operations, the "
                         "port's kernels")
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
    del plane, cases, stages
    if args.profile:
        cs.phase_profile(torch, np, args.seed)
        cs.phase_profile(torch, np, args.seed, "int8")
    print(json.dumps(out))
    return 0


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
