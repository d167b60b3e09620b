"""Primary (camera) ray generation.

Reference: `sampleRays` (path_tracer.cu:42-59): jittered pixel position
on a pinhole sensor of height 2*tan(vfov/2) at unit focal distance,
transformed by camera->world. Pixel row 0 maps to the sensor bottom;
the framebuffer pack flips vertically (path_tracer.cu:466) -- here the
film stage does the flip instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tinypathtracer_tpu.utils.math3d import vnormalize


def camera_rays_u(u, cam_to_world, yfov, aspect, px, py, width, height):
    """Generate jittered primary rays for pixel index arrays from raw
    per-lane uniforms u [N, 2].

    px, py: [N] int32 pixel coordinates. Returns (origins [N, 3],
    dirs [N, 3]); all rays share the camera origin but it is broadcast
    per lane for a uniform ray-batch interface.
    """
    tan_half = jnp.tan(0.5 * yfov)
    sensor_h = 2.0 * tan_half
    sensor_w = aspect * sensor_h
    sx = (px.astype(jnp.float32) + u[..., 0]) / width * sensor_w
    sy = (py.astype(jnp.float32) + u[..., 1]) / height * sensor_h
    d_cam = jnp.stack(
        [sx - 0.5 * sensor_w, sy - 0.5 * sensor_h, -jnp.ones_like(sx)], axis=-1)
    rot = cam_to_world[:3, :3]
    d = vnormalize(jnp.matmul(d_cam, rot.T, precision=lax.Precision.HIGHEST))
    o = jnp.broadcast_to(cam_to_world[:3, 3], d.shape)
    return o, d


def camera_rays(key, cam_to_world, yfov, aspect, px, py, width, height):
    """Key-based wrapper over camera_rays_u (tests / standalone use)."""
    u = jax.random.uniform(key, px.shape + (2,), dtype=jnp.float32)
    return camera_rays_u(u, cam_to_world, yfov, aspect, px, py, width, height)
