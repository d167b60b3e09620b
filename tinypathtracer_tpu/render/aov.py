"""AOV / debug render modes.

Equivalents of the reference's debug renders:

  * normal  -- the RENDER_NORMAL compile path (path_tracer.cu:13,
    322-342): first-hit interpolated normal, per-component ABSOLUTE
    value (`normal.habs()`), averaged over spp; miss lanes contribute
    black.
  * hitmask -- `checkHitStatus` (debug_utils.h:130-169): mid-gray
    (125/255) where the primary ray hit anything, black elsewhere.
  * depth   -- no direct reference analogue (closest to the t values
    `traverseBVH` reports); normalized 1/(1+t) so infinity maps to 0
    and near geometry is bright.

These exist to verify images cheaply when the estimator or RNG changes:
an AOV render is independent of the shading/estimator code path, so a
golden-image diff against it localizes regressions to either geometry
(AOV changed) or shading (AOV identical).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tinypathtracer_tpu.config import RenderConfig
from tinypathtracer_tpu.models.scene import FlatScene
from tinypathtracer_tpu.ops.sampling import fold_all, fold_lanes, lane_uniform
from tinypathtracer_tpu.render import raygen
from tinypathtracer_tpu.utils.math3d import REAL_MAX, vnormalize

AOV_KINDS = ("normal", "depth", "hitmask")


def render_aov(scene: FlatScene, cfg: RenderConfig, key, kind: str):
    """Render one AOV image [H, W, 3] float32 in [0, 1]."""
    if kind not in AOV_KINDS:
        raise ValueError(f"unknown AOV {kind!r}; one of {AOV_KINDS}")
    from tinypathtracer_tpu.render.renderer import prepare_state, _hit_fn

    state = prepare_state(scene, cfg)
    closest_hit = _hit_fn(state, cfg)
    data = state.data
    w, h, spp = cfg.width, cfg.height, cfg.spp

    pix = jnp.arange(w * h, dtype=jnp.int32)
    lane_pix = jnp.repeat(pix, spp)
    lane_s = jnp.tile(jnp.arange(spp, dtype=jnp.int32), w * h)
    keys = fold_lanes(key, lane_pix)
    keys = jax.vmap(jax.random.fold_in)(keys, lane_s)
    from tinypathtracer_tpu.render.renderer import _CAM_TAG

    u_cam = lane_uniform(fold_all(keys, _CAM_TAG), 2)
    o, d = raygen.camera_rays_u(u_cam, scene.cam_to_world, scene.cam_yfov,
                                scene.cam_aspect, lane_pix % w,
                                lane_pix // w, w, h)
    fid, t, uv = closest_hit(o, d)
    hit = fid >= 0

    if kind == "hitmask":
        val = jnp.where(hit, 125.0 / 255.0, 0.0)[:, None] * jnp.ones((1, 3))
    elif kind == "depth":
        val = (jnp.where(hit, 1.0 / (1.0 + t), 0.0)[:, None]
               * jnp.ones((1, 3)))
    else:  # normal
        from tinypathtracer_tpu.ops import shading_c
        from tinypathtracer_tpu.render.integrator import fetch_cols

        packT = fetch_cols(data.shade_packT, jnp.maximum(fid, 0))
        u_, v_ = uv[:, 0], uv[:, 1]
        w_ = 1.0 - u_ - v_
        nx = (w_ * packT[0] + u_ * packT[3]) + v_ * packT[6]
        ny = (w_ * packT[1] + u_ * packT[4]) + v_ * packT[7]
        nz = (w_ * packT[2] + u_ * packT[5]) + v_ * packT[8]
        nx, ny, nz = shading_c.normalize_c(nx, ny, nz, eps=1e-20)
        val = jnp.where(hit[:, None],
                        jnp.abs(jnp.stack([nx, ny, nz], axis=1)), 0.0)

    img = val.reshape(w * h, spp, 3).mean(axis=1)
    return img.reshape(h, w, 3)


def render_aov_jit(scene: FlatScene, cfg: RenderConfig, key, kind: str):
    return jax.jit(functools.partial(render_aov, cfg=cfg, kind=kind))(
        scene, key=key)
