"""Cascaded shadow maps: the host-side fit (copied from
ash_tpu/render/csm.py; reference src/renderer/resources/shadow.rs, which
never wired CSM to a GPU pass).

Practical split scheme lambda*log + (1-lambda)*linear (shadow.rs:136-162),
frustum-corner fit with texel snapping (shadow.rs:209-270), GPU-layout data
(shadow.rs:90-109), quality presets (shadow.rs:50-76). Each cascade matrix
drives one depth-only raster pass (render/frame.py:shadow_program).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core import maths

MAX_CASCADES = 4


@dataclasses.dataclass
class CsmConfig:
    """shadow.rs:19-48 defaults; presets :50-76."""

    cascade_count: int = 4
    resolution: int = 2048
    split_lambda: float = 0.75
    depth_bias: float = 0.0005
    blend_cascades: bool = True
    blend_size: float = 0.1
    enabled: bool = True

    @staticmethod
    def high_quality() -> "CsmConfig":
        return CsmConfig(4, 4096, 0.8, 0.0003, True, 0.15, True)

    @staticmethod
    def performance() -> "CsmConfig":
        return CsmConfig(2, 1024, 0.5, 0.001, False, 0.0, True)


@dataclasses.dataclass
class CascadeData:
    near: float = 0.0
    far: float = 0.0
    light_space_matrix: np.ndarray = dataclasses.field(
        default_factory=maths.mat4_identity
    )


@dataclasses.dataclass
class GpuCascadeData:
    """Shader-layout cascade block (shadow.rs:90-109)."""

    light_matrices: np.ndarray  # (4, 4, 4)
    split_distances: np.ndarray  # (4,)
    params: np.ndarray  # (4,): count, blend enabled, blend size, pad


class CascadedShadowMap:
    def __init__(self, config: CsmConfig | None = None):
        self.config = config or CsmConfig()
        self.cascades: List[CascadeData] = [
            CascadeData() for _ in range(MAX_CASCADES)
        ]
        self._update_key = None  # last (view, proj, light, dist) fitted

    def calculate_splits(self, near: float, far: float) -> np.ndarray:
        """Practical split scheme (shadow.rs:136-162)."""
        count = self.config.cascade_count
        lam = self.config.split_lambda
        splits = np.zeros(MAX_CASCADES + 1, np.float32)
        splits[0] = near
        for i in range(1, count + 1):
            p = i / count
            log_split = near * (far / near) ** p
            lin_split = near + (far - near) * p
            splits[i] = lam * log_split + (1.0 - lam) * lin_split
        splits[count + 1 :] = far
        return splits

    @staticmethod
    def frustum_corners(
        view: np.ndarray, proj: np.ndarray, near_split: float,
        far_split: float, inv_vp: np.ndarray | None = None,
    ) -> np.ndarray:
        """World-space corners of a view-frustum slice (shadow.rs:164-200).

        Deviation from the reference: its formula maps view distances to a
        GL-style [-1, 1] NDC z, but the matrices in play use [0, 1] depth
        (glam perspective_rh) — with them its slices land in the wrong world
        region (latent: the reference never wired CSM to a pass). We compute
        the NDC z of a view distance t exactly from the projection:
        ndc_z(t) = (p23 - p22 * t) / t for clip_w = t."""
        if inv_vp is None:
            inv_vp = np.linalg.inv(proj @ view)

        def ndc_z(t):
            return float((proj[2, 3] - proj[2, 2] * t) / max(t, 1e-6))

        zn = min(max(ndc_z(near_split), 0.0), 1.0)
        zf = min(max(ndc_z(far_split), 0.0), 1.0)
        ndc = np.array(
            [[-1, -1, zn, 1], [1, -1, zn, 1], [1, 1, zn, 1], [-1, 1, zn, 1],
             [-1, -1, zf, 1], [1, -1, zf, 1], [1, 1, zf, 1], [-1, 1, zf, 1]],
            np.float32,
        )
        world = ndc @ inv_vp.T  # (8, 4), one matmul for all corners
        return (world[:, :3] / world[:, 3:4]).astype(np.float32)

    def update(
        self,
        camera_view: np.ndarray,
        camera_proj: np.ndarray,
        light_dir,
        shadow_distance: float,
    ) -> None:
        """Fit each cascade's ortho light matrix (shadow.rs:209-270).

        Runs on the host every frame, so it is value-cached: a static
        camera and light re-fit nothing. A moving camera pays one fit per
        frame, with the view-projection inverse hoisted out of the
        per-cascade loop."""
        light_dir = np.asarray(light_dir, np.float32)
        key = (
            camera_view.tobytes(),
            camera_proj.tobytes(),
            light_dir.tobytes(),
            float(shadow_distance),
            # Config knobs that shape the fit: a runtime edit of
            # csm_manager.config must not serve stale cascades.
            self.config.cascade_count,
            self.config.resolution,
            self.config.split_lambda,
        )
        if key == self._update_key:
            return
        self._update_key = key
        near, far = 0.1, shadow_distance
        splits = self.calculate_splits(near, far)
        light_dir = light_dir / max(float(np.linalg.norm(light_dir)), 1e-8)
        inv_vp = np.linalg.inv(camera_proj @ camera_view)

        for i in range(self.config.cascade_count):
            corners = self.frustum_corners(
                camera_view, camera_proj, splits[i], splits[i + 1],
                inv_vp=inv_vp,
            )
            center = corners.mean(axis=0)
            max_dist = float(np.max(np.linalg.norm(corners - center, axis=-1)))
            # Texel snap for stability (shadow.rs:244-245).
            texels_per_unit = self.config.resolution / max(max_dist * 2.0, 1e-6)
            max_dist = float(np.ceil(max_dist * texels_per_unit) / texels_per_unit)

            light_pos = center - light_dir * max_dist
            light_view = maths.look_at_rh(
                light_pos, center, maths.stable_up(light_dir)
            )
            light_proj = maths.orthographic_rh(
                -max_dist, max_dist, -max_dist, max_dist, 0.0, max_dist * 2.0
            )
            self.cascades[i] = CascadeData(
                near=float(splits[i]),
                far=float(splits[i + 1]),
                light_space_matrix=(light_proj @ light_view).astype(np.float32),
            )

    def gpu_data(self) -> GpuCascadeData:
        """shadow.rs:273-293."""
        count = self.config.cascade_count
        mats = np.zeros((MAX_CASCADES, 4, 4), np.float32)
        dists = np.full(4, np.finfo(np.float32).max, np.float32)
        for i in range(count):
            mats[i] = self.cascades[i].light_space_matrix
            dists[i] = self.cascades[i].far
        return GpuCascadeData(
            light_matrices=mats,
            split_distances=dists,
            params=np.array(
                [
                    float(count),
                    1.0 if self.config.blend_cascades else 0.0,
                    self.config.blend_size,
                    0.0,
                ],
                np.float32,
            ),
        )

    def light_matrix(self, cascade: int) -> np.ndarray:
        if 0 <= cascade < self.config.cascade_count:
            return self.cascades[cascade].light_space_matrix
        return maths.mat4_identity()
