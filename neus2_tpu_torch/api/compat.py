"""pyngp-shaped attribute namespaces over the Testbed (port of
``neus2_tpu/api/compat.py``).

The reference exposes its scripting surface through pybind11 as
``testbed.nerf.<attr>`` and ``testbed.nerf.training.<attr>`` (reference
src/python_api.cu:416-487, the ``Nerf`` and ``Nerf::Training``
sub-objects), and its driver scripts (scripts/run.py, run_dynamic.py) set
them directly.  Both namespaces are thin views that read and write the
Testbed's ``TrainConfig`` (a frozen dataclass: a write swaps in a replaced
config).

Only knobs with a backing in the port are exposed: any other attribute
raises AttributeError rather than taking a setting and ignoring it.  A
write to a ``TrainConfig`` knob takes effect from the next step.
"""

from __future__ import annotations

import dataclasses

from neus2_tpu_torch.ops.image import sharpen_images  # noqa: F401  (re-export)


def _cfg_property(field: str, doc: str):
    """A property that proxies a TrainConfig field of the owning Testbed."""

    def get(self):
        return getattr(self._tb.config, field)

    def set(self, value):
        self._tb.config = dataclasses.replace(
            self._tb.config, **{field: type(getattr(self._tb.config, field))(value)})

    return property(get, set, doc=doc)


class NerfTrainingView:
    """``testbed.nerf.training`` (reference python_api.cu:429-470)."""

    def __init__(self, tb):
        self._tb = tb

    random_bg_color = _cfg_property(
        "random_bg",
        "Train transparent pixels against a per-ray random background "
        "(reference m_nerf.training.random_bg_color, testbed_nerf.cu:1642).")
    near_distance = _cfg_property(
        "near",
        "Minimum marching distance along each training ray "
        "(reference m_nerf.training.near_distance).")
    depth_supervision_lambda = _cfg_property(
        "depth_supervision_lambda",
        "Weight of the L2 depth term (reference depth_supervision_lambda).")
    optimize_extrinsics = _cfg_property(
        "optimize_extrinsics",
        "Train per-image camera pose offsets (reference "
        "m_nerf.training.optimize_extrinsics).")
    optimize_exposure = _cfg_property(
        "optimize_exposure",
        "Train per-image exposure (reference optimize_exposure).")
    optimize_focal_length = _cfg_property(
        "optimize_focal_length",
        "Train the shared focal length (reference optimize_focal_length).")

    @property
    def n_images_for_training(self) -> int:
        """Training images in the current frame's dataset (reference
        n_images_for_training, python_api.cu:448)."""
        ds = self._tb.dataset
        return 0 if ds is None else int(ds.n_images)


class NerfView:
    """``testbed.nerf`` (reference python_api.cu:416-427)."""

    def __init__(self, tb):
        self._tb = tb
        self.training = NerfTrainingView(tb)

    cone_angle_constant = _cfg_property(
        "cone_angle_constant",
        "Marching step growth dt ~ cone * t (reference m_nerf.cone_angle_constant "
        "= 1/256, testbed_nerf.cu:58).")

    @property
    def rendering_min_transmittance(self) -> float:
        """Early-out transmittance of eval renders (reference
        m_nerf.rendering_min_transmittance; eval protocol 1e-4)."""
        return self._tb.rendering_min_transmittance

    @rendering_min_transmittance.setter
    def rendering_min_transmittance(self, v: float):
        self._tb.rendering_min_transmittance = float(v)

    @property
    def render_with_camera_distortion(self) -> bool:
        """Render through the dataset's Brown-Conrady lens and the learned
        distortion grid; off renders a pinhole (reference
        m_nerf.render_with_camera_distortion)."""
        return self._tb.render_with_camera_distortion

    @render_with_camera_distortion.setter
    def render_with_camera_distortion(self, v: bool):
        self._tb.render_with_camera_distortion = bool(v)

    @property
    def sharpen(self) -> float:
        """Unsharp-mask amount applied to the training images (reference
        sharpen kernel, nerf_loader.cu:103-123, centre weight 4 + 1/amount).
        Setting re-filters the current frame's images from the dataset's
        host copy, so it does not compound."""
        return self._tb._sharpen

    @sharpen.setter
    def sharpen(self, amount: float):
        self._tb._sharpen = float(amount)
        self._tb._refresh_images()
