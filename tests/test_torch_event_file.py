"""``--tensorboard`` in the port: its own event-file writer and reader
(``neus2_tpu_torch/utils/event_file.py``) against TensorBoard's, and the
CLI's scalars against the JAX CLI's (which writes through PyTorch's
``SummaryWriter``) on a static scene and on two dynamic frames.

Tolerances: a scalar is stored as a float32, so the two writers' files
read back identically (no tolerance); a CLI scalar equals the loss that
log.txt prints at its step to the printed 5 decimals (within 5e-6 plus
one float32 rounding of the value).  The two CLIs' values are not
compared: their random streams (threefry and Philox) differ.
"""

import dataclasses
import json
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from torch.utils.tensorboard import SummaryWriter

from neus2_tpu import run as jrun
from neus2_tpu.api import testbed as jax_testbed
from neus2_tpu.data.export import save_dataset_na
from neus2_tpu.data.synthetic import make_moving_sphere_frames as jax_frames
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu_torch import run
from neus2_tpu_torch.api import testbed as port_testbed
from neus2_tpu_torch.utils import event_file
from neus2_tpu_torch.utils.event_file import EventFileWriter, read_scalars

torch.set_num_threads(2)

NETWORK = {
    "encoding": {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 12,
                 "base_resolution": 16, "per_level_scale": 1.45},
    "network": {"n_neurons": 16, "n_hidden_layers": 1},
    "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2},
}
STEPS = 100  # the CLIs log every 100 steps
OCC_N_PROBE = 1 << 12
TAGS = ("loss/ek", "loss/mask", "loss/rgb")
LOG_LINE = re.compile(r"^step (\d+) \(frame (\d+) local (\d+)\) loss=(\S+) ek=(\S+) mask=(\S+) ")


@pytest.mark.parametrize("data, crc", [
    (b"123456789", 0xE3069283),
    (b"", 0x00000000),
    (bytes(32), 0x8A9136AA),  # RFC 3720 B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
])
def test_crc32c_check_vectors(data, crc):
    assert event_file.crc32c(data) == crc


def accumulated(log_dir) -> dict:
    """{tag: [(step, value), ...]} as TensorBoard's ``EventAccumulator``
    reads a directory."""
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}


def test_writer_reads_as_summary_writers_file(tmp_path):
    """One sequence of scalars through the port's writer and through
    ``SummaryWriter``: TensorBoard's reader and the port's give the same
    tags, steps and values for both files."""
    rng = np.random.default_rng(0)
    seq = [(tag, float(v), step) for step in (0, 1, 100, 200, 2**40)
           for tag, v in zip(TAGS + ("a/b c",),
                             rng.normal(size=4) * 10.0 ** rng.integers(-8, 8, 4))]
    seq.append(("loss/rgb", -1.5, -7))
    ours, theirs = EventFileWriter(tmp_path / "port"), SummaryWriter(str(tmp_path / "tb"))
    for tag, value, step in seq:
        ours.add_scalar(tag, value, step)
        theirs.add_scalar(tag, value, step)
    ours.close()
    theirs.close()
    want = {}
    for tag, value, step in seq:
        want.setdefault(tag, []).append((step, float(np.float32(value))))
    assert read_scalars(tmp_path / "port") == want
    assert read_scalars(tmp_path / "tb") == want
    assert accumulated(tmp_path / "port") == accumulated(tmp_path / "tb") == want
    [path] = (tmp_path / "port").iterdir()
    assert re.fullmatch(r"events\.out\.tfevents\.\d{10}\..+\.\d+\.\d+", path.name)


@pytest.mark.parametrize("offset, match", [(0, "bad length checksum"),
                                           (12, "bad payload checksum")])
def test_reader_checks_both_checksums(tmp_path, offset, match):
    """One bit flipped in the scalar record's length or payload fails its
    checksum."""
    w = EventFileWriter(tmp_path)
    w.add_scalar("loss/rgb", 0.25, 100)
    w.close()
    data = bytearray(w.path.read_bytes())
    second = 12 + struct.unpack("<Q", data[:8])[0] + 4  # after the file_version record
    data[second + offset] ^= 1
    w.path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match):
        read_scalars(w.path)


def write_scene(d: Path, dynamic: bool) -> Path:
    if not dynamic:
        return Path(save_dataset_na(jax_sphere(n_views=4, resolution=16, seed=0), d / "train"))
    scene = d / "dyn"
    scene.mkdir()
    for k, ds in enumerate(jax_frames(n_frames=2, n_views=4, resolution=16)):
        js = Path(save_dataset_na(ds, d / f"f{k}"))
        meta = json.loads(js.read_text())
        for f in meta["frames"]:
            f["file_path"] = str(js.parent / f["file_path"])
        (scene / f"frame_{k:03d}.json").write_text(json.dumps(meta))
    return scene


def layout(logs: Path) -> dict:
    """{directory relative to logs: {tag: [steps]}} of every directory
    under ``logs`` holding event files."""
    out = {}
    for d in sorted({p.parent for p in logs.rglob("events.out.tfevents.*")}):
        out[str(d.relative_to(logs))] = {t: [s for s, _ in v] for t, v in read_scalars(d).items()}
    return out


def small_probe(monkeypatch, module):
    """``module.config_from_json`` with OCC_N_PROBE occupancy probes a step
    (the CLI has no flag for it; the default 2^17 would take most of the
    CPU run)."""
    read = module.config_from_json

    def config_from_json(path):
        config, hyper = read(path)
        return dataclasses.replace(config, occ_n_probe=OCC_N_PROBE), hyper

    monkeypatch.setattr(module, "config_from_json", config_from_json)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_cli_tensorboard_matches_the_log_and_the_jax_cli(tmp_path, monkeypatch, dynamic):
    """``--tensorboard --device cpu`` for 100 steps (a dynamic scene: 2
    frames of 100): the global writer's three losses at every 100th global
    step, and on a dynamic scene frame k's rgb loss under logs/frame_<k>
    at the frame's step, equal to the losses log.txt prints there; the
    JAX CLI at the same settings writes the same directories, tags and
    steps."""
    small_probe(monkeypatch, port_testbed)
    small_probe(monkeypatch, jax_testbed)
    scene = write_scene(tmp_path, dynamic)
    (tmp_path / "net.json").write_text(json.dumps(NETWORK))
    common = ["--scene", str(scene), "--network", str(tmp_path / "net.json"),
              "--output_dir", str(tmp_path / "out"), "--n_steps", str(STEPS),
              "--next_frame_steps", str(STEPS), "--n_rays", "64", "--samples_per_ray", "16",
              "--tensorboard"]
    tb = run.main([*common, "--name", "port", "--device", "cpu"])
    jrun.main([*common, "--name", "jax"])
    out = tmp_path / "out" / "port"
    frames = 2 if dynamic else 1
    assert tb.current_training_time_frame == frames - 1 and tb.training_step == STEPS

    printed = [LOG_LINE.match(line).groups() for line in (out / "log.txt").read_text().splitlines()
               if LOG_LINE.match(line)]
    assert [int(p[0]) for p in printed] == [STEPS * (k + 1) for k in range(frames)]
    want = {"loss/rgb": [], "loss/ek": [], "loss/mask": []}
    per_frame = {}
    for step, frame, local, rgb, ek, mask in printed:
        for tag, v in zip(("loss/rgb", "loss/ek", "loss/mask"), (rgb, ek, mask)):
            want[tag].append((int(step), float(v)))
        per_frame[f"frame_{frame}"] = [(int(local), float(rgb))]

    def same(got, want):
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert np.isfinite(g) and abs(g - w) <= 5e-6 + abs(w) * 2**-23, (g, w)

    logs = out / "logs"
    scalars = read_scalars(logs)
    assert sorted(scalars) == sorted(TAGS)
    for tag in TAGS:
        same(scalars[tag], want[tag])
    if dynamic:
        for name, rows in per_frame.items():
            same(read_scalars(logs / name)["loss/rgb"], rows)
    got = layout(logs)
    expected = {".": {t: [s for s, _ in want[t]] for t in TAGS}}
    if dynamic:
        expected.update({name: {"loss/rgb": [STEPS]} for name in per_frame})
    assert got == expected
    assert layout(tmp_path / "out" / "jax" / "logs") == got
    assert accumulated(logs) == {t: [(s, float(np.float32(v))) for s, v in scalars[t]]
                                 for t in TAGS}
