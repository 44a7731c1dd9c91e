#!/usr/bin/env python3
"""Time one source tree's flash_prefill and sparse_decode_attention kernels
at the fp serve's shapes, under chip_smoke.py's Timer with and without its
~0.1 ms device spin.

    python3 ab_kernels.py [--src DIR] [--seed 0] [--label NAME]

DIR is the ``src`` directory whose ``repro_torch`` is built and timed
(default: this checkout's).  Given the ``src`` of another checkout, for
example an earlier commit unpacked with ``git archive`` into a git-ignored
directory, it times that version's kernels with this checkout's timer, so
two versions can be compared in one call on one card (run them in the
order A, B, B, A).

Shapes: flash_prefill at the serve prefill's first launch (qwen2-0.5b,
B 1, Sq = Sk 4096, Hq 14, Hkv 2, D 64, q_offset 0), with SDPA on the same
inputs; sparse_decode_attention at the serve's decode step (B 4, Hq 14,
Hkv 2, NB 136, K 64, bs 32, D 64, cur_len 4112, every selection valid:
512 live blocks, as the serve replay has).  Each kernel is held against
its plain version with chip_smoke.py's tolerance first.  Prints one JSON
line; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import LIBS
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
    cases = {
        "sparse_decode_attention": cs.case_attention(
            torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len),
        "flash_prefill": cs.case_flash(torch, ops, ref, fq, fk, fv,
                                       scale=D ** -0.5),
    }
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
               "bound_ms": cs.bound_ms(nbytes, nops)[0]}
        for tname, timer in timers.items():
            rec[f"ms_{tname}"] = timer(kern)
            if len(case) > 7 and case[7] is not None:
                rec[f"library_ms_{tname}"] = timer(case[7])
        out[name] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
