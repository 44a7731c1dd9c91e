"""Rank program of the port's mesh-body tests: run on the CPU by
``torch.multiprocessing.spawn`` with the gloo backend and a ``file://``
store (no network), one spawn per world size, every case in it.

Imports torch and the port only (no jax: the parent test holds the
results against the reference).  The parent pickles the cases (numpy
inputs, the reference's weights as numpy, the port's configs) into
``cases.pkl``; each rank writes ``rank<r>.pkl``: per case, its outputs as
numpy.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.launch.plane_mesh import PlaneMesh
from repro_torch.models import ffn
from repro_torch.models import model as M


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_ep(pm: PlaneMesh, case: dict) -> dict:
    """moe_apply_ep on this rank's expert shard and data rows."""
    cfg = case["cfg"]
    p = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"])
    y, aux, (gates, experts) = ffn.moe_apply_ep(
        sharding.expert_shard(p, pm), cfg, sharding.shard_rows(x, pm),
        pm=pm, drop_free=case["drop_free"], return_routing=True)
    rows = pm.rows(x.shape[0])
    return {"y": _np(y), "aux": float(aux), "gates": _np(gates),
            "experts": _np(experts), "rows": (rows.start, rows.stop)}


def run_cp(pm: PlaneMesh, case: dict) -> dict:
    """The port's plain prefill on the full weights, then its
    context-parallel decode_step on this rank's shard of the state."""
    cfg = case["cfg"]
    params = params_from_numpy(case["params"], cfg.num_layers,
                               device="cpu")
    _, state = M.prefill(params, cfg,
                         {"tokens": torch.from_numpy(case["tokens"])},
                         case["nb"], cache_dtype=torch.float32)
    state = sharding.decode_state_shard(state, pm)
    logits, sel = [], []
    for toks in case["steps"]:
        lg, state, info = M.decode_step(
            params, cfg, torch.from_numpy(toks), state, return_info=True,
            plane_mesh=pm)
        logits.append(_np(lg))
        sel.append({i: _np(v) for i, v in info["selected"].items()})
    return {"logits": logits, "selected": sel}


def run_sp(pm: PlaneMesh, case: dict) -> dict:
    """The sequence-parallel prefill layer on the full window."""
    cfg = case["cfg"]
    p = params_from_numpy(case["params"], cfg.num_layers,
                          device="cpu")["layers"][0]
    t = {k: torch.from_numpy(case[k]) for k in
         ("h", "positions", "token_mask", "step_mask")}
    x, (k, v) = M.prefill_attn_layer_batched(
        p, cfg, t["h"], t["positions"], t["token_mask"], t["step_mask"],
        plane_mesh=pm)
    return {"x": _np(x), "k": _np(k), "v": _np(v)}


RUNNERS = {"ep": run_ep, "cp": run_cp, "sp": run_sp}


def run(rank: int, world: int, workdir: str) -> None:
    """``torch.multiprocessing.spawn``'s entry: join the gloo group of
    ``world`` ranks through a file store in ``workdir``, lay out every
    model-axis size the cases name, run every case."""
    torch.set_num_threads(1)
    work = Path(workdir)
    cases = pickle.loads((work / "cases.pkl").read_bytes())
    first = cases[0]["model"]
    meshes = {first: PlaneMesh(mesh_mod.init_local(
        rank, world, "gloo", f"file://{work / 'store'}", model=first,
        timeout_s=120.0))}
    for case in cases:     # every rank lays out the same meshes in order
        if case["model"] not in meshes:
            meshes[case["model"]] = PlaneMesh(
                mesh_mod.mesh_of_process_group(case["model"]))
    out = [RUNNERS[c["kind"]](meshes[c["model"]], c) for c in cases]
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    mesh_mod.close()


def spawn(cases: list, world: int, workdir: Path) -> list:
    """Run ``cases`` (dicts with "kind", "model" and the runner's inputs)
    on ``world`` gloo ranks; returns each rank's list of results."""
    import torch.multiprocessing as mp
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "cases.pkl").write_bytes(pickle.dumps(cases))
    mp.spawn(run, args=(world, str(workdir)), nprocs=world, join=True)
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]
