"""Small 3D math helpers.

Host-side (numpy) transform composition used while flattening scenes,
plus device-side (jnp) vector helpers used inside kernels.

The reference implements these as C++ header math (vec.h/mat.h/quat.h/
transform.h): column-major Mat4, TRS composition Translate*Rotate*Scale
(transform.h:28-33), quaternion->Mat3 (quat.h:52-69), and a
cofactor-expansion Mat4 inverse. Here the per-vertex/per-ray math is
batched over the leading axis, so all of these become (…, 3)/(4, 4)
array ops; there is no hand-rolled rsqrt (vec.h:25-38) because XLA's
`lax.rsqrt` already lowers to the hardware instruction.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

Real = np.float32
DELTA = Real(2e-4)  # self-intersection epsilon (reference vec.h MathConst::Delta)
REAL_MAX = Real(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Host-side (numpy, float64 internally then cast): scene flattening math.
# ---------------------------------------------------------------------------

def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from quaternion given as (x, y, z, w) (glTF order).

    Matches reference quat.h:52-69 (column-major Mat3 built from unit
    quaternion; a zero quaternion degenerates to identity, which the
    reference relies on for nodes without rotation).
    """
    x, y, z, w = [float(v) for v in q]
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array(
        [
            [1.0 - 2.0 * (y2 + z2), 2.0 * (xy - wz), 2.0 * (xz + wy)],
            [2.0 * (xy + wz), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz - wx)],
            [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (x2 + y2)],
        ],
        dtype=np.float64,
    )


def trs_to_mat4(
    translation=(0.0, 0.0, 0.0),
    rotation=(0.0, 0.0, 0.0, 0.0),
    scale=(1.0, 1.0, 1.0),
) -> np.ndarray:
    """local->world = Translate @ Rotate @ Scale (reference transform.h:28-33)."""
    m = np.eye(4, dtype=np.float64)
    r = quat_to_mat3(np.asarray(rotation, dtype=np.float64))
    s = np.diag(np.asarray(scale, dtype=np.float64))
    m[:3, :3] = r @ s
    m[:3, 3] = np.asarray(translation, dtype=np.float64)
    return m


def normal_matrix(l2w: np.ndarray) -> np.ndarray:
    """Normal transform: inverse-transpose of the linear part.

    Matches reference mesh.cu:371-378 (normal_to_world), which strips
    translation then returns transpose(M)^-1.
    """
    lin = np.array(l2w[:3, :3], dtype=np.float64)
    return np.linalg.inv(lin.T)


def euler_zxy_to_quat(angles_deg) -> np.ndarray:
    """Euler degrees (ZXY application order) -> quaternion (x, y, z, w).

    Matches reference quat.h:13-27.
    """
    ax, ay, az = [np.deg2rad(float(a)) * 0.5 for a in angles_deg]
    cx, cy, cz = np.cos([ax, ay, az])
    sx, sy, sz = np.sin([ax, ay, az])
    w = cx * cy * cz - sx * sy * sz
    x = sx * cy * cz - cx * sy * sz
    y = cx * sy * cz + sx * cy * sz
    z = sx * sy * cz + cx * cy * sz
    return np.array([x, y, z, w], dtype=np.float64)


# ---------------------------------------------------------------------------
# Device-side (jnp): batched vector helpers for kernels. All operate on
# (..., 3) arrays and are shape-polymorphic over leading batch dims.
# ---------------------------------------------------------------------------

def vdot(a, b):
    """Batched dot product over the trailing axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def vcross(a, b):
    return jnp.cross(a, b)


def vnorm2(a):
    return jnp.sum(a * a, axis=-1)


def vnormalize(a, eps=0.0):
    """Normalize over the trailing axis using the hardware rsqrt."""
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    return a * lax.rsqrt(jnp.maximum(n2, eps))


def transform_dirs(m4, dirs):
    """Apply a 4x4 (or batched) to (..., 3) directions (w=0).

    Elementwise multiply-adds, not a matmul: a float32 matmul may run in
    TF32 on a GPU, which would move hit points."""
    return (m4[..., :3, 0] * dirs[..., 0:1] + m4[..., :3, 1] * dirs[..., 1:2]
            + m4[..., :3, 2] * dirs[..., 2:3])


def transform_points(m4, pts):
    """Apply a 4x4 (or batched [..., 4, 4]) to (..., 3) points (w=1)."""
    return transform_dirs(m4, pts) + m4[..., :3, 3]


def reflect(d, n):
    """Mirror reflect direction d about normal n (reference path_tracer.cu:137-141)."""
    return d - 2.0 * vdot(d, n)[..., None] * n


def build_onb(n):
    """Orthonormal basis (t, b) around unit normal n.

    Reference sampler.h:75-79 uses xBase = normalize((1, 0, -n.x/n.z))
    (or (0,0,1) if n.z == 0) and zBase = cross(xBase, n). We reproduce
    that frame so hemisphere samples map to the same directions for a
    given (u1, u2) pair, with the division guarded for vectorization.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    z_zero = nz == 0.0
    safe_nz = jnp.where(z_zero, 1.0, nz)
    x_raw = jnp.stack(
        [jnp.where(z_zero, 0.0, 1.0),
         jnp.zeros_like(nx),
         jnp.where(z_zero, 1.0, -nx / safe_nz)],
        axis=-1,
    )
    t = vnormalize(x_raw)
    b = vcross(t, n)
    return t, b
