"""Local ``(data, model)`` layouts of ranks over ``torch.distributed``,
and the port's collectives.

Counterpart of the reference's ``launch/mesh.py`` (``make_local_mesh``).
Where the reference lays a JAX mesh over
the devices of one process, here each rank is a process with one card:
``init_local`` joins the process group (its backend, address, world
size and rank given by the caller: nothing on a machine tells a program
of a cluster) and lays the ranks out row-major over ``(data, model)``,
as ``jax.make_mesh`` lays devices, so rank r sits at data index
r // model and model index r % model, and the ranks of one model group
are consecutive.  The reference's production 256- and 512-chip meshes
have no counterpart here.

The collectives every mesh body of the port runs go through the three
functions at the end (``all_reduce_sum``, ``all_reduce_max`` and
``all_gather``), on whatever backend the process group was given; each
is called even on a group of one rank, so a world of one still runs the
backend's own calls.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A ``(data, model)`` layout and this rank's place in it: ``shape``
    (data size, model size), ``rank`` the global rank, and the process
    groups of this rank's data and model axes (None where no process
    group exists: a layout for the sharding rules alone, or one rank)."""
    shape: Tuple[int, int]
    rank: int = 0
    backend: Optional[str] = None
    data_group: Any = dataclasses.field(default=None, compare=False)
    model_group: Any = dataclasses.field(default=None, compare=False)

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape[1]


def _axis_groups(world: int, model: int):
    """Every model group's ranks (consecutive), then every data group's
    (strided by ``model``), in the order every rank must create them."""
    data = world // model
    return ([list(range(d * model, (d + 1) * model)) for d in range(data)],
            [list(range(j, world, model)) for j in range(model)])


def _new_group(ranks, world: int):
    # a group over every rank is the default group itself
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def mesh_of_process_group(model: int) -> LocalMesh:
    """The layout of the joined process group with a ``model``-way model
    axis, its groups created (a collective call: every rank makes it)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"of {world} ranks")
    model_sets, data_sets = _axis_groups(world, model)
    groups = {}
    for axis, sets in (("model", model_sets), ("data", data_sets)):
        for ranks in sets:
            g = _new_group(ranks, world)
            if rank in ranks:
                groups[axis] = g
    return LocalMesh((world // model, model), rank, dist.get_backend(),
                     groups["data"], groups["model"])


def init_local(rank: int, world: int, backend: str, init_method: str, *,
               model: int = 1, timeout_s: float = 300.0) -> LocalMesh:
    """Join the process group (``backend`` "nccl" or "gloo", named by the
    caller; ``init_method`` e.g. ``tcp://localhost:<port>`` or
    ``file://<path>``) as ``rank`` of ``world`` and lay the ranks out over
    ``(world // model, model)``.  A rank that drives a card should have
    selected it (``torch.cuda.set_device``) first."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return mesh_of_process_group(model)


def close() -> None:
    """Leave the process group (every rank)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, in place; returns
    ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``group``, in
    place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order (the reference's ``all_gather(..., tiled=True)``), a new
    tensor."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
