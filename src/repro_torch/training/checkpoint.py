"""Checkpoints: save and restore parameter and optimizer trees to
``.npz``, the counterpart of the reference package's
``repro/training/checkpoint.py`` with the same file format: leaves under
their ``/``-joined key paths (dict keys, list indices), the step under
``__step__``, written to a temporary file and renamed into place so that
a checkpoint is never torn.  bfloat16 leaves (numpy has no such dtype)
are stored as float32 and cast back on restore.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import tree_leaves_with_path


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in tree_leaves_with_path(tree):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat["/".join(path)] = t.cpu().numpy()
    return flat


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)      # savez keeps the name (ends in .npz)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_checkpoint(path: str, reference: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``reference``: new tensors with each
    reference leaf's dtype and device.  Returns (tree, step); raises
    ``KeyError`` on a missing key and ``ValueError`` on a shape
    mismatch."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__", 0))
    by_path = {}
    for path_k, leaf in tree_leaves_with_path(reference):
        key = "/".join(path_k)
        if key not in flat:
            raise KeyError(f"checkpoint missing key {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        by_path[path_k] = torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype)

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v, path + (str(i),)) for i, v in enumerate(tree)]
        return by_path[path]
    return rebuild(reference), step
