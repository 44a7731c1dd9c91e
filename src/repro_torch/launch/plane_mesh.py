"""PlaneMesh: what the port's mesh bodies need to shard, over
``torch.distributed``.

Counterpart of the reference's ``launch/plane_mesh.py`` (``PlaneMesh``:
``resolve``, ``model_size``, ``dp_size``, ``dp_entry``,
``pool_shard_mode``, ``round_blocks``).  An instance holds a
``launch.mesh.LocalMesh`` (its sizes, this rank's place and its group
handles) where the reference's holds a JAX ``Mesh``; the layout rules
are the reference's.  The reference's ``stage_sharding`` and
``replicate`` (GSPMD shardings of the staged planes' jitted stages) have
no counterpart: a rank's tensors here are its own shard, and what the
bodies hand back is replicated by their collectives.

The bodies that take one (``models.model.decode_step(...,
plane_mesh=)``, ``models.model.prefill_attn_layer_batched(...,
plane_mesh=)``, ``models.ffn.moe_apply_ep``) shard as the reference's
fused ``plane_mesh`` bodies do: decode pools over the BLOCK axis of the
model axis (each rank appends and scores its own blocks, the scores are
gathered, every rank selects the same global top-k and attends over its
own selected blocks, and the flash partials merge by log-sum-exp), batch
rows over the data axis where they divide it; a prefill window's
queries over the model axis; experts over the model axis.  The staged
planes' sharded stages (``EngineConfig.mesh_spec``) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist

from repro_torch.launch.mesh import LocalMesh, mesh_of_process_group


@dataclasses.dataclass(frozen=True)
class PlaneMesh:
    """A ``(data, model)`` layout: everything a body needs to shard.
    The data axis carries batch rows; the model axis the context-parallel
    dimension (pool blocks, a prefill window's queries, or experts,
    chosen per body)."""
    mesh: LocalMesh

    # -- construction ------------------------------------------------------

    @classmethod
    def of_sizes(cls, data: int = 1, model: int = 1) -> "PlaneMesh":
        """A layout without process groups, for the sharding rules alone
        (or one rank on its own)."""
        return cls(LocalMesh((data, model)))

    @classmethod
    def resolve(cls, spec: Any) -> Optional["PlaneMesh"]:
        """A mesh spec -> PlaneMesh | None, the reference's accepted
        specs: ``None`` (no mesh), a ``PlaneMesh``, a ``LocalMesh`` (in
        place of the reference's JAX ``Mesh``), an int K or the string
        ``"model=K"``: a K-way model axis over the ranks of the joined
        process group (one rank without one), its groups created, which
        every rank must do alike.  Raises ``ValueError`` on another spec
        or a K that does not divide the ranks."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, LocalMesh):
            return cls(spec)
        if isinstance(spec, int):
            k = spec
        elif isinstance(spec, str):
            body = spec.strip()
            if "=" in body:
                key, _, val = body.partition("=")
                if key.strip() != "model":
                    raise ValueError(f"unknown mesh_spec {spec!r}; expected "
                                     f"'model=K', an int, a LocalMesh or a "
                                     f"PlaneMesh")
                k = int(val)
            else:
                k = int(body)
        else:
            raise ValueError(f"cannot resolve mesh_spec {spec!r}")
        n = dist.get_world_size() if dist.is_initialized() else 1
        if k < 1 or n % k != 0:
            raise ValueError(f"model axis {k} does not divide the "
                             f"{n} available ranks")
        if not dist.is_initialized():
            return cls.of_sizes(1, 1)
        return cls(mesh_of_process_group(k))

    # -- sizes -------------------------------------------------------------

    @property
    def model_size(self) -> int:
        return self.mesh.shape[1]

    @property
    def dp_size(self) -> int:
        return self.mesh.shape[0]

    @property
    def model_rank(self) -> int:
        return self.mesh.model_rank

    @property
    def data_rank(self) -> int:
        return self.mesh.data_rank

    @property
    def model_group(self):
        return self.mesh.model_group

    @property
    def data_group(self):
        return self.mesh.data_group

    # -- layout rules ------------------------------------------------------

    def dp_entry(self, dim: int) -> Optional[str]:
        """``"data"`` for a batch-row axis of size ``dim`` that the data
        axis divides, else None (replicated: e.g. B = 2 on a 4-way data
        axis)."""
        n = self.dp_size
        return "data" if n > 1 and dim % n == 0 else None

    def rows(self, dim: int) -> slice:
        """The batch rows of this rank: its data shard where ``dp_entry``
        shards them, else every row."""
        if self.dp_entry(dim) is None:
            return slice(0, dim)
        per = dim // self.dp_size
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def pool_shard_mode(self, cfg) -> str:
        """'heads' | 'blocks': which pool axis the model axis shards.
        KV-head sharding needs ``Hkv % n_model == 0`` and a real head
        axis; MLA's latent pool has one head, so it (and GQA head counts
        that do not divide the axis) shards the block axis."""
        n = self.model_size
        if (cfg.attention_type != "mla" and cfg.num_kv_heads >= n
                and cfg.num_kv_heads % n == 0):
            return "heads"
        return "blocks"

    def round_blocks(self, cfg, nb: int) -> int:
        """Pool block capacity rounded so the sharded pool divides evenly
        (only block mode shards the block axis)."""
        if self.pool_shard_mode(cfg) != "blocks":
            return nb
        n = self.model_size
        return -(-nb // n) * n
