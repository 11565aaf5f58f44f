"""The port stands alone: it imports neither JAX nor the JAX package, nor
``flax``, ``msgpack`` or ``imageio``, which the card's machine lacks, and
its entry points refuse to fall back to the CPU when CUDA is absent."""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import neus2_tpu_torch

torch.set_num_threads(2)
PKG = Path(neus2_tpu_torch.__file__).parent
MODULES = sorted(
    m.name for m in pkgutil.walk_packages([str(PKG)], prefix="neus2_tpu_torch.")
)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k in ('jax', 'neus2_tpu', 'flax', 'msgpack', 'imageio') "
        "or k.startswith(('jax.', 'optax', 'neus2_tpu.', 'flax.', 'msgpack.', "
        "'imageio.')))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) >= 20


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")), ids=lambda p: p.name
)
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|optax|neus2_tpu\b(?!_torch))",
                         text, re.M)
    assert "neus2_tpu." not in text.replace("neus2_tpu_torch.", "")
    assert not re.search(r"\bjax\b|\boptax\b|\bjnp\b", text)
    assert "torch.utils.tensorboard" not in text


def test_tensorboard_logging_needs_no_tensorboard(tmp_path):
    """``--tensorboard`` writes and reads its event files with the port's
    own code: importing the CLI and the event-file module, writing a
    scalar and reading it back loads no ``tensorboard``, ``tensorflow`` or
    ``protobuf`` module (the card's machine has none of them)."""
    code = (
        "import json, sys\n"
        "import neus2_tpu_torch.run\n"
        "from neus2_tpu_torch.utils.event_file import EventFileWriter, read_scalars\n"
        f"w = EventFileWriter({str(tmp_path)!r}); w.add_scalar('loss/rgb', 0.5, 100); w.close()\n"
        f"assert read_scalars({str(tmp_path)!r}) == {{'loss/rgb': [(100, 0.5)]}}\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('tensorboard', 'tensorflow', 'tensorboardX') or k.startswith('google.protobuf'))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from neus2_tpu_torch.engine import train as tt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.TrainConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_train_state(cfg, device="cuda:0")
