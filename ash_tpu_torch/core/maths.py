"""Host-side 3D math: 4x4 matrices, quaternions, camera projections.

TPU-native replacement for the reference's use of `glam` (Rust). All matrices
are float32 numpy arrays in **row-major math convention**: a point transforms as
``M @ [x, y, z, 1]``. This is numerically identical to glam's column-major
``Mat4 * Vec4``; glam's ``m.y_axis.y`` is our ``m[1, 1]`` and ``m.w_axis.x`` is
our ``m[0, 3]``.

Projection conventions follow glam's right-handed, zero-to-one depth variants
(`Mat4::perspective_rh` / `orthographic_rh`), which is what the reference uses
for Vulkan (reference: src/renderer/resources/transform.rs:102-114,
src/renderer/shadow_map.rs:224-247). The Vulkan Y-flip
(``proj.y_axis.y *= -1``) is applied by :func:`ash_tpu_torch.core.transform.Camera`.

The port's copy of ash_tpu/core/maths.py: the same float operations in the
same order on numpy arrays, without the reference's jax.numpy branch.
"""

from __future__ import annotations

import numpy as np

Array = np.ndarray

_EPS = 1e-8


def vec3(x, y, z, dtype=np.float32) -> Array:
    return np.array([x, y, z], dtype=dtype)


def vec4(x, y, z, w, dtype=np.float32) -> Array:
    return np.array([x, y, z, w], dtype=dtype)


def normalize(v):
    n = np.linalg.norm(v)
    return v / np.maximum(n, _EPS)


def mat4_identity() -> Array:
    return np.eye(4, dtype=np.float32)


def mat4_translation(t) -> Array:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def mat4_scale(s) -> Array:
    s = np.asarray(s, dtype=np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def quat_identity() -> Array:
    """Quaternion as (x, y, z, w) — glam's memory order."""
    return np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_from_axis_angle(axis, angle: float) -> Array:
    axis = normalize(np.asarray(axis, dtype=np.float32))
    half = 0.5 * angle
    s = np.sin(half)
    return np.array(
        [axis[0] * s, axis[1] * s, axis[2] * s, np.cos(half)], dtype=np.float32
    )


def quat_from_euler_xyz(ex: float, ey: float, ez: float) -> Array:
    """Intrinsic XYZ euler to quaternion (matches glam EulerRot::XYZ,
    reference: src/renderer/resources/transform.rs:29-36)."""
    qx = quat_from_axis_angle([1.0, 0.0, 0.0], ex)
    qy = quat_from_axis_angle([0.0, 1.0, 0.0], ey)
    qz = quat_from_axis_angle([0.0, 0.0, 1.0], ez)
    return quat_mul(quat_mul(qx, qy), qz)


def quat_mul(a: Array, b: Array) -> Array:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=np.float32,
    )


def mat4_from_quat(q: Array) -> Array:
    x, y, z, w = np.asarray(q, dtype=np.float32)
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 1.0 - (yy + zz)
    m[0, 1] = xy - wz
    m[0, 2] = xz + wy
    m[1, 0] = xy + wz
    m[1, 1] = 1.0 - (xx + zz)
    m[1, 2] = yz - wx
    m[2, 0] = xz - wy
    m[2, 1] = yz + wx
    m[2, 2] = 1.0 - (xx + yy)
    return m


def mat4_trs(translation, rotation_quat, scale) -> Array:
    """Translation * Rotation * Scale (reference:
    src/renderer/resources/transform.rs:22-26)."""
    return (
        mat4_translation(translation)
        @ mat4_from_quat(rotation_quat)
        @ mat4_scale(scale)
    )


def mat4_trs_batch(translation, rotation_quat, scale) -> Array:
    """Vectorized TRS -> (N, 4, 4): T * R(quat xyzw) * S, the reference
    compose (transform.rs:22-26). ELEMENTWISE formulation — rotation columns
    scaled, translation placed — whose float ops match mat4_trs's T@R@S
    result bitwise (each matmul element reduces to one multiply), and match
    the in-jit compose in render/frame.models_from_trs op for op, so
    host-composed and device-composed frames are pixel-identical."""
    t = np.asarray(translation, np.float32).reshape(-1, 3)
    q = np.asarray(rotation_quat, np.float32).reshape(-1, 4)
    s = np.asarray(scale, np.float32).reshape(t.shape[0], 3)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    n = t.shape[0]
    m = np.zeros((n, 4, 4), np.float32)
    m[:, 0, 0] = (1.0 - (yy + zz)) * s[:, 0]
    m[:, 0, 1] = (xy - wz) * s[:, 1]
    m[:, 0, 2] = (xz + wy) * s[:, 2]
    m[:, 1, 0] = (xy + wz) * s[:, 0]
    m[:, 1, 1] = (1.0 - (xx + zz)) * s[:, 1]
    m[:, 1, 2] = (yz - wx) * s[:, 2]
    m[:, 2, 0] = (xz - wy) * s[:, 0]
    m[:, 2, 1] = (yz + wx) * s[:, 1]
    m[:, 2, 2] = (1.0 - (xx + yy)) * s[:, 2]
    m[:, :3, 3] = t
    m[:, 3, 3] = 1.0
    return m


def look_at_rh(eye, center, up) -> Array:
    """Right-handed look-at view matrix (glam `Mat4::look_at_rh`).

    Reference consumers: camera view (transform.rs:102-104) and the shadow
    light view (shadow_map.rs:233-234).

    It is scalarized: this runs per frame per shadow
    cascade, and np.cross/concatenate/stack on 3-vectors cost ~0.25 ms
    per call in Python dispatch overhead — ~1 ms/frame of the rich
    config's host path before this.
    """
    ex, ey, ez = (float(v) for v in eye)
    fx, fy, fz = (float(c) - e for c, e in zip(center, (ex, ey, ez)))
    n = max((fx * fx + fy * fy + fz * fz) ** 0.5, float(_EPS))
    fx, fy, fz = fx / n, fy / n, fz / n
    ux, uy, uz = (float(v) for v in up)
    sx = fy * uz - fz * uy
    sy = fz * ux - fx * uz
    sz = fx * uy - fy * ux
    n = max((sx * sx + sy * sy + sz * sz) ** 0.5, float(_EPS))
    sx, sy, sz = sx / n, sy / n, sz / n
    ux = sy * fz - sz * fy
    uy = sz * fx - sx * fz
    uz = sx * fy - sy * fx
    m = np.array(
        [
            [sx, sy, sz, -(sx * ex + sy * ey + sz * ez)],
            [ux, uy, uz, -(ux * ex + uy * ey + uz * ez)],
            [-fx, -fy, -fz, fx * ex + fy * ey + fz * ez],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
    return m


def perspective_rh(fov_y_radians: float, aspect: float, z_near: float, z_far: float) -> Array:
    """Right-handed perspective with [0, 1] depth (glam `Mat4::perspective_rh`).

    NDC z = 0 at the near plane, 1 at the far plane; camera looks down -Z.
    Reference: transform.rs:108-114 (before the Vulkan Y-flip).
    """
    h = 1.0 / np.tan(0.5 * fov_y_radians)
    w = h / aspect
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def stable_up(direction) -> list:
    """An up vector that is never parallel to `direction`.

    look_at_rh with up parallel to the view direction degenerates to a
    zero basis (the cross product vanishes; glam behaves the same, and the
    reference hardcodes up=[0,1,0] for its shadow view, shadow_map.rs:233
    — a straight-down noon light breaks its shadows too). Shadow fitting
    here switches to +Z when the light is within ~2.5 degrees of vertical;
    a documented deviation."""
    d = np.asarray(direction, np.float32)
    d = d / max(float(np.linalg.norm(d)), 1e-8)
    if abs(float(d[1])) > 0.999:
        return [0.0, 0.0, 1.0]
    return [0.0, 1.0, 0.0]


def orthographic_rh(left, right, bottom, top, near, far) -> Array:
    """Right-handed orthographic with [0, 1] depth (glam `Mat4::orthographic_rh`).

    Reference: the shadow light projection (shadow_map.rs:237-244) and CSM
    cascade projections (resources/shadow.rs:252-259).
    """
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 2] = 1.0 / (near - far)
    m[2, 3] = near / (near - far)
    return m


def mat4_inverse(m: Array) -> Array:
    return np.linalg.inv(m).astype(np.float32)


def normal_matrix(model: Array) -> Array:
    """(model^-1)^T used for transforming normals (reference:
    src/renderer/renderer.rs:1654, shaders/vert.vert:38-39)."""
    return mat4_inverse(model).T.astype(np.float32)


def transform_point(m: Array, p) -> Array:
    """Apply a 4x4 to a 3D point (w = 1) with perspective divide."""
    p4 = np.concatenate([np.asarray(p, dtype=np.float32), np.ones((1,), np.float32)])
    out = m @ p4
    return out[:3] / out[3]


def transform_vector(m: Array, v) -> Array:
    """Apply a 4x4 to a direction (w = 0)."""
    return (m[:3, :3] @ np.asarray(v, dtype=np.float32)).astype(np.float32)


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence value (reference:
    src/renderer/temporal_aa.rs:62-71)."""
    f = 1.0
    r = 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r
