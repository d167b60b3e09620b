"""Component-form (SoA) shading math for the hot bounce loop.

Every per-lane quantity is a plain [N] array (vectors as three [N]
components) instead of an [N, 3] array, so no op broadcasts an [N]
array into an [N, 3] vector (`cos_t[:, None] * normal` and friends).
Whether this form still pays on the GPU is an open measurement
(ROADMAP S5).

Every function here is an ORDER-PRESERVING transcription of its [N, 3]
counterpart in ops/sampling.py, ops/bsdf.py, utils/math3d.py and
models/envlight.py (same operations, same association), so results are
bit-identical and all estimator-semantics citations live with the
originals. The originals remain the reference implementations for
tests and non-hot paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

PI = 3.141592653589793


def dot_c(ax, ay, az, bx, by, bz):
    """(a.x*b.x + a.y*b.y) + a.z*b.z -- jnp.sum's reduction order."""
    return (ax * bx + ay * by) + az * bz


def normalize_c(ax, ay, az, eps=0.0):
    """math3d.vnormalize component form (rsqrt of clamped norm^2)."""
    inv = lax.rsqrt(jnp.maximum((ax * ax + ay * ay) + az * az, eps))
    return ax * inv, ay * inv, az * inv


def reflect_c(dx, dy, dz, nx, ny, nz):
    """math3d.reflect: d - 2 (d.n) n."""
    k = 2.0 * dot_c(dx, dy, dz, nx, ny, nz)
    return dx - k * nx, dy - k * ny, dz - k * nz


def build_onb_c(nx, ny, nz):
    """math3d.build_onb (reference sampler.h:75-79 frame): returns
    (tx, ty, tz, bx, by, bz). ty == 0 by construction."""
    z_zero = nz == 0.0
    safe_nz = jnp.where(z_zero, 1.0, nz)
    rx = jnp.where(z_zero, 0.0, 1.0)
    rz = jnp.where(z_zero, 1.0, -nx / safe_nz)
    inv = lax.rsqrt(jnp.maximum(rx * rx + rz * rz, 0.0))
    tx, tz = rx * inv, rz * inv
    ty = jnp.zeros_like(tx)
    # b = cross(t, n) with t.y == 0
    bx = ty * nz - tz * ny
    by = tz * nx - tx * nz
    bz = tx * ny - ty * nx
    return tx, ty, tz, bx, by, bz


def hemisphere_cosine_c(u1, u2, nx, ny, nz):
    """sampling.hemisphere_cosine_u component form.

    Returns (dx, dy, dz, pdf)."""
    phi = 2.0 * PI * u1
    cos_t = jnp.sqrt(u2)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))
    tx, ty, tz, bx, by, bz = build_onb_c(nx, ny, nz)
    a = jnp.cos(phi) * sin_t
    c = jnp.sin(phi) * sin_t
    dx = (a * tx + cos_t * nx) + c * bx
    dy = (a * ty + cos_t * ny) + c * by
    dz = (a * tz + cos_t * nz) + c * bz
    return dx, dy, dz, cos_t / PI


def refract_reference_c(dx, dy, dz, nx, ny, nz, ior):
    """bsdf.refract_reference component form. Returns
    (rx, ry, rz, cos_i_abs, eta, tir)."""
    cos_i = dot_c(dx, dy, dz, nx, ny, nz)
    exiting = cos_i > 0.0
    ior_safe = jnp.where(ior > 0.0, ior, 1.0)
    eta = jnp.where(exiting, ior_safe, 1.0 / ior_safe)
    sx = jnp.where(exiting, -nx, nx)
    sy = jnp.where(exiting, -ny, ny)
    sz = jnp.where(exiting, -nz, nz)
    cos_i_abs = jnp.abs(cos_i)
    sin2_t = eta * eta * (1.0 - cos_i_abs * cos_i_abs)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - jnp.where(tir, 0.0, sin2_t), 0.0))
    k = cos_i_abs * eta - cos_t
    rx = jnp.where(tir, 0.0, eta * dx + k * sx)
    ry = jnp.where(tir, 0.0, eta * dy + k * sy)
    rz = jnp.where(tir, 0.0, eta * dz + k * sz)
    return rx, ry, rz, cos_i_abs, eta, tir


def schlick_fresnel(cos_i, eta):
    """bsdf.schlick_fresnel (already scalar [N])."""
    f0 = (1.0 - eta) / (1.0 + eta)
    f0 = f0 * f0
    m = jnp.clip(1.0 - cos_i, 0.0, 1.0)
    m2 = m * m
    return f0 + (1.0 - f0) * m2 * m2 * m


def sample_bsdf_c(u1, u2, u3, dx, dy, dz, nx, ny, nz, eta, metallic):
    """bsdf.sample_bsdf_u component form, WITHOUT the baseColor factor
    (callers multiply throughput by base_color * ratio themselves).

    Returns (ndx, ndy, ndz, ratio, is_specular); weight_rgb =
    base_color * ratio exactly as in sample_bsdf_u.
    """
    rfx, rfy, rfz, cos_i, eta_r, tir = refract_reference_c(
        dx, dy, dz, nx, ny, nz, eta)
    rlx, rly, rlz = reflect_c(dx, dy, dz, nx, ny, nz)
    fr = jnp.where(tir, 1.0, schlick_fresnel(cos_i, eta_r))
    take_refl = u3 < fr
    ddx = jnp.where(take_refl, rlx, rfx)
    ddy = jnp.where(take_refl, rly, rfy)
    ddz = jnp.where(take_refl, rlz, rfz)

    sign = jnp.where(dot_c(dx, dy, dz, nx, ny, nz) > 0.0, -1.0, 1.0)
    nsx, nsy, nsz = nx * sign, ny * sign, nz * sign
    hx, hy, hz, pdf = hemisphere_cosine_c(u1, u2, nsx, nsy, nsz)
    cos_o = dot_c(hx, hy, hz, nsx, nsy, nsz)
    atten = jnp.abs(cos_o) / PI
    diff_ratio = atten / jnp.maximum(pdf, 1e-12)

    is_dielec = eta > 0.0
    is_mirror = jnp.logical_and(~is_dielec, metallic > 0.0)
    is_specular = is_dielec | is_mirror

    ndx = jnp.where(is_dielec, ddx, jnp.where(is_mirror, rlx, hx))
    ndy = jnp.where(is_dielec, ddy, jnp.where(is_mirror, rly, hy))
    ndz = jnp.where(is_dielec, ddz, jnp.where(is_mirror, rlz, hz))
    ratio = jnp.where(is_specular, 1.0, diff_ratio)
    return ndx, ndy, ndz, ratio, is_specular


def env_texel_c(h, w, dx, dy, dz):
    """models/envlight.dir_to_uv + texel selection, component form.
    Returns the flat texel index [N] i32 (row * w + col)."""
    dx = lax.stop_gradient(dx)
    dy = lax.stop_gradient(dy)
    dz = lax.stop_gradient(dz)
    u = jnp.arctan2(dz, dx) / (2.0 * PI)
    u = jnp.where(u < 0.0, u + 1.0, u)
    v = 1.0 - jnp.arccos(jnp.clip(dy, -1.0, 1.0)) / PI
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip(((1.0 - v) * h).astype(jnp.int32), 0, h - 1)
    return row * w + col
