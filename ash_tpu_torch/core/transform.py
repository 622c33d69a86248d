"""Transform, MVP and Camera — the scene-space math API.

TPU-native re-implementation of reference src/renderer/resources/transform.rs.
The public surface (fields, defaults, conventions) matches the reference so an
application can port unchanged; the matrices feed the jitted frame function as
ordinary arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import maths


@dataclasses.dataclass
class Transform:
    """TRS transform (reference: transform.rs:4-37)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    rotation: np.ndarray = dataclasses.field(default_factory=maths.quat_identity)
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )

    @staticmethod
    def identity() -> "Transform":
        return Transform()

    def model_matrix(self) -> np.ndarray:
        """Translation * Rotation * Scale (transform.rs:22-26)."""
        return maths.mat4_trs(self.position, self.rotation, self.scale)

    def set_rotation(self, euler) -> None:
        """Set rotation from XYZ euler radians (transform.rs:29-31)."""
        ex, ey, ez = np.asarray(euler, dtype=np.float32)
        self.rotation = maths.quat_from_euler_xyz(float(ex), float(ey), float(ez))

    def rotate(self, euler) -> None:
        """Accumulate an XYZ euler rotation (transform.rs:34-36)."""
        ex, ey, ez = np.asarray(euler, dtype=np.float32)
        self.rotation = maths.quat_mul(
            self.rotation, maths.quat_from_euler_xyz(float(ex), float(ey), float(ez))
        )


@dataclasses.dataclass
class MVP:
    """Model/View/Projection triple (reference: transform.rs:40-61)."""

    model: np.ndarray
    view: np.ndarray
    projection: np.ndarray

    def combined(self) -> np.ndarray:
        """projection * view * model (transform.rs:58-60)."""
        return (self.projection @ self.view @ self.model).astype(np.float32)


@dataclasses.dataclass
class Camera:
    """Perspective camera with the reference's defaults and the Vulkan Y-flip.

    Reference: transform.rs:63-115. Defaults: position (0,0,3) looking at the
    origin, fov 45 deg, near 0.5, far 100 (transform.rs:76-86).
    """

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 3.0], np.float32)
    )
    target: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32)
    )
    fov: float = 45.0  # degrees
    aspect: float = 1.0
    near: float = 0.5
    far: float = 100.0

    @staticmethod
    def default(aspect: float) -> "Camera":
        return Camera(aspect=aspect)

    @staticmethod
    def new(position, target, aspect: float) -> "Camera":
        return Camera(
            position=np.asarray(position, np.float32),
            target=np.asarray(target, np.float32),
            aspect=aspect,
        )

    def view_matrix(self) -> np.ndarray:
        return maths.look_at_rh(self.position, self.target, self.up)

    def projection_matrix(self) -> np.ndarray:
        """Perspective with Vulkan NDC Y-flip (transform.rs:108-114).

        The flip keeps our matrices bit-identical to the reference so that
        golden-frame comparisons line up; the rasterizer's viewport transform
        accounts for the resulting NDC orientation.
        """
        proj = maths.perspective_rh(
            np.deg2rad(self.fov), self.aspect, self.near, self.far
        )
        proj[1, 1] *= -1.0
        return proj
