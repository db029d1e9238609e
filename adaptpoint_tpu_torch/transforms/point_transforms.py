"""Point-cloud data transforms (host-side numpy, per sample).

Counterpart of ``adaptpoint_tpu/transforms/point_transforms.py`` for the
transforms the classification and S3DIS cfgs use (reference
openpoints/transforms/point_transformer_gpu.py:35-314 and
point_transform_cpu.py): PointsToTensor, PointCloudScaling,
PointCloudCenterAndNormalize (heights from the pre-centering gravity axis),
PointCloudRotation (per-axis uniform angles, random composition order),
PointCloudXYZAlign (centred in the floor plane, the floor at 0) and
PointCloudJitter (clipped gaussian noise).
Each draws from the generator it is given in the JAX package's order.
"""
from __future__ import annotations

import numpy as np

from .transforms_factory import DataTransforms

__all__ = ["PointsToTensor", "PointCloudScaling",
           "PointCloudCenterAndNormalize", "PointCloudRotation",
           "PointCloudXYZAlign", "PointCloudJitter"]


def _rot_single_axis(axis_ind: int, theta: float) -> np.ndarray:
    """Rotation matrix about a coordinate axis (Rodrigues for unit axes)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3, dtype=np.float64)
    a, b = [(1, 2), (0, 2), (0, 1)][axis_ind]
    m[a, a] = c
    m[b, b] = c
    sign = -1.0 if axis_ind == 1 else 1.0
    m[a, b] = -s * sign
    m[b, a] = s * sign
    return m


@DataTransforms.register_module()
class PointsToTensor:
    """No-op marker kept for config parity (point_transform_cpu.py:7-19):
    arrays stay numpy float32 until batch upload."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data, rng):
        data["pos"] = np.asarray(data["pos"], np.float32)
        return data


@DataTransforms.register_module()
class PointCloudScaling:
    """Anisotropic random scaling (parity: point_transformer_gpu.py:135-166)."""

    def __init__(self, scale=(2.0 / 3.0, 3.0 / 2.0), anisotropic=True,
                 scale_xyz=(True, True, True), mirror=(0, 0, 0), **kwargs):
        self.scale_min, self.scale_max = float(scale[0]), float(scale[1])
        self.anisotropic = anisotropic
        self.scale_xyz = scale_xyz
        self.mirror = np.asarray(mirror, np.float32)
        self.use_mirroring = (self.mirror > 0).sum() != 0

    def __call__(self, data, rng):
        scale = rng.uniform(self.scale_min, self.scale_max,
                            size=3 if self.anisotropic else 1).astype(np.float32)
        if self.use_mirroring:
            mirror = (rng.random(3) > self.mirror).astype(np.float32) * 2 - 1
            scale = scale * mirror
        for i, s in enumerate(self.scale_xyz):
            if not s:
                scale[i] = 1.0
        data["pos"] = data["pos"] * scale
        return data


@DataTransforms.register_module()
class PointCloudCenterAndNormalize:
    """Height feature + centering + unit-sphere normalization
    (parity: point_transformer_gpu.py:35-68)."""

    def __init__(self, centering=True, normalize=True, gravity_dim=2,
                 append_xyz=False, **kwargs):
        self.centering = centering
        self.normalize = normalize
        self.gravity_dim = gravity_dim
        self.append_xyz = append_xyz

    def __call__(self, data, rng):
        pos = data["pos"]
        if self.append_xyz:
            data["heights"] = (pos - pos.min()).astype(np.float32)
        else:
            h = pos[:, self.gravity_dim:self.gravity_dim + 1]
            data["heights"] = (h - h.min()).astype(np.float32)
        if self.centering:
            pos = pos - pos.mean(axis=0, keepdims=True)
        if self.normalize:
            m = np.sqrt((pos ** 2).sum(axis=-1, keepdims=True)).max(axis=0, keepdims=True)
            pos = pos / m
        data["pos"] = pos.astype(np.float32)
        return data


@DataTransforms.register_module()
class PointCloudRotation:
    """Random rotation with per-axis uniform angles composed in random order
    (parity: point_transformer_gpu.py:267-314)."""

    def __init__(self, angle=(0.0, 0.0, 0.0), **kwargs):
        self.angle = np.asarray(angle, np.float64) * np.pi

    def __call__(self, data, rng):
        mats = []
        for axis_ind, bound in enumerate(self.angle):
            theta = rng.uniform(-bound, bound) if bound else 0.0
            mats.append(_rot_single_axis(axis_ind, theta))
        rng.shuffle(mats)
        rot = (mats[0] @ mats[1] @ mats[2]).astype(np.float32)
        data["pos"] = data["pos"] @ rot.T
        if "normals" in data:
            data["normals"] = data["normals"] @ rot.T
        return data


@DataTransforms.register_module()
class PointCloudXYZAlign:
    """Centre the cloud, then move its lowest point along the gravity axis
    to 0 (parity: point_transformer_gpu.py:71-90)."""

    def __init__(self, gravity_dim=2, **kwargs):
        self.gravity_dim = gravity_dim

    def __call__(self, data, rng):
        pos = data["pos"] - data["pos"].mean(axis=0, keepdims=True)
        pos[:, self.gravity_dim] -= pos[:, self.gravity_dim].min()
        data["pos"] = pos.astype(np.float32)
        return data


@DataTransforms.register_module()
class PointCloudJitter:
    """Gaussian noise of ``jitter_sigma`` on each coordinate, clipped to
    +-``jitter_clip`` (parity: point_transformer_gpu.py PointCloudJitter)."""

    def __init__(self, jitter_sigma=0.01, jitter_clip=0.05, **kwargs):
        self.sigma = jitter_sigma
        self.clip = jitter_clip

    def __call__(self, data, rng):
        noise = np.clip(rng.standard_normal(data["pos"].shape) * self.sigma,
                        -self.clip, self.clip).astype(np.float32)
        data["pos"] = data["pos"] + noise
        return data
