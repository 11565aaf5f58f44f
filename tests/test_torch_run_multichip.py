"""The port's CLI with data-parallel training on the CPU: two gloo ranks
under ``torchrun`` (replicated and ZeRO-1), the CLI spawning its own rank
(``--multichip on`` started plainly), and ``--multihost`` with one process
(tests/test_parallel.py::test_run_cli_multihost_flag).  Rank 0 alone
writes the log, the snapshot and the mesh (``--save_mesh``, or the
Chamfer eval's mesh of ``--ref_mesh``) while every rank reaches the write;
the log names the world and the global batch.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neus2_tpu_torch import run
from neus2_tpu_torch.api import msgpack_codec
from neus2_tpu_torch.data.export import save_dataset_na
from neus2_tpu_torch.data.synthetic import make_sphere_dataset, sphere_sdf
from neus2_tpu_torch.engine.mesh import save_mesh_obj
from neus2_tpu_torch.native import marching_cubes

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
NETWORK = {
    "encoding": {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 12,
                 "base_resolution": 16, "per_level_scale": 1.45},
    "network": {"n_neurons": 16, "n_hidden_layers": 1},
    "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2},
}
STEPS = 4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("multichip")
    save_dataset_na(make_sphere_dataset(n_views=4, resolution=24, seed=0), d / "train")
    (d / "net.json").write_text(json.dumps(NETWORK))
    xs = (np.arange(24) + 0.5) / 24  # the true sphere's mesh, in the dataset's space
    v, f = marching_cubes(sphere_sdf(np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1))
                          .astype(np.float32))
    save_mesh_obj(d / "ref.obj", ((v + 0.5) / 24).astype(np.float32), f, offset=(0.5, 0.5, 0.5))
    return d


def _args(d: Path, name: str) -> list:
    return ["--scene", str(d / "train" / "transforms.json"), "--network", str(d / "net.json"),
            "--name", name, "--output_dir", str(d / "out"), "--n_steps", str(STEPS),
            "--n_rays", "128", "--samples_per_ray", "16", "--device", "cpu"]


def _final(d: Path, name: str) -> dict:
    ckpt = d / "out" / name / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["final.msgpack"]
    final = msgpack_codec.unpackb((ckpt / "final.msgpack").read_bytes())
    assert int(final["meta"]["training_step"]) == STEPS
    return final


@pytest.mark.parametrize("zero1", [False, True], ids=["replicated", "zero1"])
def test_cli_trains_on_two_ranks_under_torchrun(scene, zero1):
    """Replicated with ``--ref_mesh`` alone (the eval's own mesh), ZeRO-1
    with ``--save_mesh --ref_mesh``: each mesh write holds both ranks."""
    name = "z1" if zero1 else "rep"
    mesh_args = ["--ref_mesh", str(scene / "ref.obj"), "--mesh_resolution", "24"]
    if zero1:
        mesh_args += ["--save_mesh", "--zero1"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "neus2_tpu_torch.run", *_args(scene, name), "--multichip", "on"]
    res = subprocess.run(cmd + mesh_args, env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    log = (scene / "out" / name / "log.txt").read_text()
    want = ("multichip: data-parallel over 2 ranks (128 rays/batch global, 64 a rank"
            + (", zero1 table sharding)" if zero1 else ")"))
    assert log.count(want) == 1 and res.stdout.count(want) == 1
    assert log.count("training done") == 1
    meshes = sorted(p.name for p in (scene / "out" / name / "mesh").iterdir())
    assert meshes == ["mesh.obj" if zero1 else "eval_mesh.obj"]
    assert log.count(f"chamfer vs {scene / 'ref.obj'}: ") == 1
    cd = float(log.split(f"chamfer vs {scene / 'ref.obj'}: ")[1].split()[0])
    assert 0.0 < cd < 0.5
    final = _final(scene, name)
    # The whole Adam state, gathered from the ranks' halves under ZeRO-1.
    mu = final["leaves"][".opt_state['mu']['hashgrid'][3]"]
    assert mu.shape == final["leaves"][".params['hashgrid'][3]"].shape and np.abs(mu).max() > 0


def test_cli_multichip_on_spawns_its_ranks(scene):
    """Started plainly, ``--multichip on`` spawns one rank a device (one
    on the CPU) and returns nothing; the rank trains and writes."""
    assert run.main(_args(scene, "spawned") + ["--multichip", "on"]) is None
    _final(scene, "spawned")
    log = (scene / "out" / "spawned" / "log.txt").read_text()
    assert "data-parallel over 1 ranks" in log
    assert not torch.distributed.is_initialized()


def test_cli_multihost_one_process(scene):
    tb = run.main(_args(scene, "mh") + ["--multihost", "--num_processes", "1",
                                        "--multichip", "off"])
    assert tb.parallel is None and np.isfinite(tb.loss_scalar)
    _final(scene, "mh")
    assert not torch.distributed.is_initialized()
