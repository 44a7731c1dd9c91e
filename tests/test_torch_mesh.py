"""The port's ``PlaneMesh`` rules (``repro_torch.launch.plane_mesh``)
against the reference's ``repro.launch.plane_mesh.PlaneMesh``:
``resolve``'s accepted specs and its errors, and ``pool_shard_mode``,
``round_blocks``, ``dp_size`` and ``dp_entry`` for all twelve smoke
configs at model sizes 1, 2, 4 and 8 over 8 devices.  The reference's
sizes above 1 come from one subprocess with 8 forced host devices, as
``tests/test_distributed.py`` runs it (this process keeps seeing one
CPU device); the port's come from layouts of those sizes without a
process group (``PlaneMesh.of_sizes``).  Also the layout of a joined
process group (gloo, one rank, a ``file://`` store) and the collectives
on it."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.launch.plane_mesh import PlaneMesh as JPlaneMesh
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.plane_mesh import PlaneMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 2, 4, 8)
NBS = (1, 5, 7, 8, 33)
DIMS = (1, 2, 3, 4, 8)


@pytest.fixture(scope="module")
def reference_rules():
    """{arch: {model size: [mode, [round_blocks], dp_size, [dp_entry]]}}
    from the reference over 8 forced host devices."""
    code = textwrap.dedent(f"""
        import json
        from repro.configs import ALL_ARCHS, get_smoke_config
        from repro.launch.plane_mesh import PlaneMesh
        out = {{}}
        for k in {SIZES!r}:
            pm = PlaneMesh.resolve(f"model={{k}}")
            for arch in ALL_ARCHS:
                cfg = get_smoke_config(arch)
                out.setdefault(arch, {{}})[str(k)] = [
                    pm.pool_shard_mode(cfg),
                    [pm.round_blocks(cfg, nb) for nb in {NBS!r}],
                    pm.dp_size, [pm.dp_entry(d) for d in {DIMS!r}]]
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_match_reference_at_every_model_size(arch, reference_rules):
    cfg = torch_smoke(arch)
    for k in SIZES:
        pm = PlaneMesh.of_sizes(8 // k, k)
        assert pm.model_size == k and pm.dp_size == 8 // k
        got = [pm.pool_shard_mode(cfg), [pm.round_blocks(cfg, nb)
                                         for nb in NBS],
               pm.dp_size, [pm.dp_entry(d) for d in DIMS]]
        assert got == reference_rules[arch][str(k)], (arch, k)


SPECS = (None, 1, "model=1", " model = 1 ", "1", "rings=3", 9, "model=0",
         0, 3.5, "model=x")


def _outcome(resolve, spec):
    try:
        pm = resolve(spec)
    except ValueError:
        return "ValueError"
    return None if pm is None else (pm.model_size, pm.dp_size)


@pytest.mark.parametrize("spec", SPECS)
def test_resolve_matches_reference_on_one_device(spec):
    """One device (the reference) and one rank without a process group
    (the port) accept and refuse the same specs."""
    assert _outcome(PlaneMesh.resolve, spec) == \
        _outcome(JPlaneMesh.resolve, spec)


def test_resolve_keeps_instances_and_takes_a_layout():
    pm = PlaneMesh.resolve("model=1")
    assert PlaneMesh.resolve(pm) is pm
    assert PlaneMesh.resolve(pm.mesh) == pm
    assert pm.rows(3) == slice(0, 3)
    two = PlaneMesh.of_sizes(2, 2)
    assert two.dp_entry(4) == "data" and two.dp_entry(3) is None


def test_one_rank_process_group_and_its_collectives(tmp_path):
    """gloo at world size 1 (a file store): ``resolve`` lays the joined
    group out, and the three collectives run on its groups."""
    mesh = mesh_mod.init_local(0, 1, "gloo", f"file://{tmp_path / 's'}")
    try:
        assert (mesh.shape, mesh.rank, mesh.backend) == ((1, 1), 0, "gloo")
        pm = PlaneMesh.resolve("model=1")
        assert (pm.model_size, pm.model_rank, pm.data_rank) == (1, 0, 0)
        with pytest.raises(ValueError):
            PlaneMesh.resolve(2)
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(mesh_mod.all_gather(x, 1, pm.model_group), x)
        assert torch.equal(mesh_mod.all_reduce_sum(x.clone(),
                                                   pm.data_group), x)
        assert torch.equal(mesh_mod.all_reduce_max(x.clone(),
                                                   pm.model_group), x)
    finally:
        mesh_mod.close()
