"""Keyframed camera paths: spline interpolation and json save/load (a
copy of ``neus2_tpu/utils/camera_path.py``, which is numpy alone: the port
imports nothing of the JAX package).

The reference's CameraPath (src/camera_path.cu, camera_path.h: keyframes
of pose and fov, Catmull-Rom interpolation, json) without the ImGui
editor: paths are written in code or loaded from json.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Keyframe:
    pose: np.ndarray  # (3, 4) camera-to-world
    fov_deg: float = 45.0

    def to_json(self):
        return {"pose": self.pose.tolist(), "fov_deg": self.fov_deg}

    @staticmethod
    def from_json(d):
        return Keyframe(np.asarray(d["pose"], np.float32), float(d.get("fov_deg", 45.0)))


def _slerp(r0: np.ndarray, r1: np.ndarray, t: float) -> np.ndarray:
    """Rotation slerp via axis-angle of the relative rotation."""
    m = r1 @ r0.T
    cos_a = np.clip((np.trace(m) - 1.0) * 0.5, -1.0, 1.0)
    angle = np.arccos(cos_a)
    if angle < 1e-8:
        return r0
    axis = (
        np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
        / (2.0 * np.sin(angle))
    )
    a = angle * t
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    rot_t = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)
    return rot_t @ r0


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t3
    )


@dataclasses.dataclass
class CameraPath:
    keyframes: list[Keyframe] = dataclasses.field(default_factory=list)
    loop: bool = False

    def eval(self, u: float) -> Keyframe:
        """Interpolated camera at u in [0, 1] along the path."""
        n = len(self.keyframes)
        if n == 0:
            raise ValueError("empty camera path")
        if n == 1:
            return self.keyframes[0]
        segs = n if self.loop else n - 1
        s = np.clip(u, 0.0, 1.0) * segs
        i = min(int(s), segs - 1)
        t = s - i

        def kf(j):
            return self.keyframes[j % n if self.loop else min(max(j, 0), n - 1)]

        p = _catmull_rom(
            kf(i - 1).pose[:, 3], kf(i).pose[:, 3], kf(i + 1).pose[:, 3],
            kf(i + 2).pose[:, 3], t,
        )
        r = _slerp(kf(i).pose[:, :3], kf(i + 1).pose[:, :3], t)
        fov = (1 - t) * kf(i).fov_deg + t * kf(i + 1).fov_deg
        return Keyframe(np.concatenate([r, p[:, None]], axis=1).astype(np.float32), fov)

    def save(self, path: str | Path):
        with open(path, "w") as f:
            json.dump(
                {"loop": self.loop, "keyframes": [k.to_json() for k in self.keyframes]},
                f,
                indent=1,
            )

    @staticmethod
    def load(path: str | Path) -> "CameraPath":
        with open(path) as f:
            d = json.load(f)
        return CameraPath(
            keyframes=[Keyframe.from_json(k) for k in d["keyframes"]],
            loop=bool(d.get("loop", False)),
        )


def orbit_path(
    center=(0.5, 0.5, 0.5), radius: float = 1.2, height: float = 0.2,
    n_keyframes: int = 8, fov_deg: float = 45.0,
) -> CameraPath:
    """Convenience circular orbit around the scene center."""
    center = np.asarray(center, np.float32)
    kfs = []
    for k in range(n_keyframes):
        phi = 2 * np.pi * k / n_keyframes
        eye = center + np.array(
            [radius * np.cos(phi), radius * np.sin(phi), height], np.float32
        )
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0], np.float32)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        pose = np.stack([right, down, fwd, eye], axis=1).astype(np.float32)
        kfs.append(Keyframe(pose, fov_deg))
    return CameraPath(keyframes=kfs, loop=True)
