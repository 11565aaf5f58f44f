"""What the benchmark loads: the reference and the checks load nothing of
the program or of JAX; the harness, its drives and the program's modules
they reach load neither JAX nor the JAX package (top-level module names
compared whole: ``neus2_tpu_torch`` begins with ``neus2_tpu``); and a
directory with the benchmark's files alone gives no result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _top_level_modules(code: str) -> set:
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_no_program_and_no_jax():
    mods = _top_level_modules(
        "from portbench import manifest\n"
        "import portbench.reference.nets, portbench.reference.steps, portbench.scene\n"
        "manifest.load_module('checks', 'train'); manifest.load_module('checks', 'render')\n")
    assert not mods & {"neus2_tpu_torch", "neus2_tpu", "jax", "jaxlib", "flax"}


def test_the_harness_loads_no_jax():
    mods = _top_level_modules(
        "from portbench import manifest, harness\n"
        "b = manifest.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = manifest.cell(w['name'])\n"
        "    manifest.load_module('drives', c.traffic['drive'])\n"
        "    manifest.load_module('checks', c.traffic['check'])\n"
        "    [manifest.load_module('metrics', m['name']) for m in c.per_layer]\n"
        "import neus2_tpu_torch.api.testbed, neus2_tpu_torch.engine.render\n"
        "import neus2_tpu_torch.ops.segment_tile, neus2_tpu_torch.data.dataset\n"
        "assert harness.forbidden_modules() == []\n")
    assert "neus2_tpu_torch" in mods
    assert not mods & {"neus2_tpu", "jax", "jaxlib", "flax"}


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "base.b0", "--seed",
                          "1", "--seconds", "1"], capture_output=True, text=True, cwd=tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "program is missing" in res.stderr
