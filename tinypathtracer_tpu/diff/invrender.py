"""Differentiable / inverse rendering.

The reference renderer is forward-only; differentiability is a
capability this framework adds (BASELINE.json north star: gradients
w.r.t. materials, lights, and camera with pixel-gradient allclose vs
finite differences). Design:

  * the integrator is differentiable end-to-end by construction: hit
    ids are detached (integrator.hit_query), every shading quantity is
    recomputed with differentiable ops, and all RNG is
    counter-based -- so jax.grad of the render IS path-replay
    backprop: the backward pass replays the exact same paths because
    the keys, not mutable state, define them;
  * `Params` picks out the differentiable leaves (material colors,
    scalar emissions, light intensities, env map, camera pose);
  * `train_step` is a standard optax loop; the sharded variant
    (grads psum over the mesh) lives in parallel/shard.py's style and
    is assembled in make_sharded_train_step below.

Memory: reverse-mode through the bounce scan stores per-bounce
residuals; `remat_sample` wraps each spp sample in jax.checkpoint so
the live set is one bounce deep regardless of spp.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import optax

from tinypathtracer_tpu.config import RenderConfig
from tinypathtracer_tpu.models.scene import FlatScene
from tinypathtracer_tpu.parallel.mesh import DATA_AXIS, SAMPLE_AXIS
from tinypathtracer_tpu.render import renderer as rend


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Params:
    """Differentiable scene parameters (gradient leaves)."""

    mtl_base_color: jnp.ndarray   # [M, 3]
    mtl_emission: jnp.ndarray     # [M]
    light_intensity: jnp.ndarray  # [L]
    env_radiance: jnp.ndarray     # [He, We, 3]
    cam_to_world: jnp.ndarray     # [4, 4]
    tex_atlas: jnp.ndarray        # [T, Ht, Wt, 3] base-color texels

    @staticmethod
    def from_scene(scene: FlatScene) -> "Params":
        return Params(
            mtl_base_color=scene.mtl_base_color,
            mtl_emission=scene.mtl_emission,
            light_intensity=scene.light_intensity,
            env_radiance=scene.env_radiance,
            cam_to_world=scene.cam_to_world,
            tex_atlas=scene.tex_atlas,
        )


def apply_params(scene: FlatScene, params: Params) -> FlatScene:
    """Return a scene with the differentiable leaves swapped in."""
    return dataclasses.replace(
        scene,
        mtl_base_color=params.mtl_base_color,
        mtl_emission=params.mtl_emission,
        light_intensity=params.light_intensity,
        env_radiance=params.env_radiance,
        cam_to_world=params.cam_to_world,
        tex_atlas=params.tex_atlas,
    )


def render_mean(scene: FlatScene, cfg: RenderConfig, key):
    """Differentiable mean-radiance image [H, W, 3] (bottom-up rows,
    i.e. raw pixel order -- flip only for display)."""
    return rend.render_frame(scene, cfg, key) / cfg.spp


def mse_loss(params: Params, scene: FlatScene, cfg: RenderConfig, target, key):
    """Mean squared error against a target radiance image."""
    img = render_mean(apply_params(scene, params), cfg, key)
    return jnp.mean(jnp.square(img - target))


def project_physical(params: Params) -> Params:
    """Default feasibility projection: albedo in [0, 1], emission and
    light intensity non-negative (unconstrained steps that push albedo
    negative explode through multiplicative emission terms)."""
    return dataclasses.replace(
        params,
        mtl_base_color=jnp.clip(params.mtl_base_color, 0.0, 1.0),
        mtl_emission=jnp.maximum(params.mtl_emission, 0.0),
        light_intensity=jnp.maximum(params.light_intensity, 0.0),
        env_radiance=jnp.maximum(params.env_radiance, 0.0),
    )


def make_train_step(cfg: RenderConfig, optimizer: optax.GradientTransformation,
                    loss_fn: Callable = mse_loss,
                    project_fn: Optional[Callable] = None):
    """Single-device jitted train step:
    (params, opt_state, scene, target, key) -> (params, opt_state, loss)."""

    @jax.jit
    def step(params, opt_state, scene, target, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, cfg, target, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if project_fn is not None:
            params = project_fn(params)
        return params, opt_state, loss

    return step


def make_sharded_train_step(cfg: RenderConfig, mesh: Mesh,
                            optimizer: optax.GradientTransformation,
                            project_fn: Optional[Callable] = None):
    """Distributed train step: pixels shard over "data", spp over
    "sample"; per-device gradients are `psum`-averaged over the whole
    mesh (XLA's scheduler can overlap the all-reduce with the backward
    pass), then the optimizer update runs replicated.

    Returns a jitted fn (params, opt_state, scene, target, key) ->
    (params, opt_state, loss). `target` is the full [H, W, 3] image.
    """
    from jax import shard_map
    from tinypathtracer_tpu.parallel.shard import _padded_pixels

    n_data = mesh.shape[DATA_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if cfg.spp % n_sample:
        raise ValueError(f"spp={cfg.spp} % sample axis {n_sample} != 0")
    spp_local = cfg.spp // n_sample
    tile = min(cfg.tile_pixels, -(-cfg.n_pixels // n_data))

    def per_device(params, opt_state, scene, target_flat, pix_shard, key):
        def local_loss(p):
            state = rend.prepare_state(apply_params(scene, p), cfg)
            off = lax.axis_index(SAMPLE_AXIS) * spp_local
            rad = rend.render_pixel_ids(state, cfg, jnp.maximum(pix_shard, 0),
                                        key, spp=spp_local, sample_offset=off)
            rad = lax.psum(rad, SAMPLE_AXIS) / cfg.spp
            tgt = target_flat                      # [P/n_data, 3] shard
            valid = (pix_shard[:, None] >= 0).astype(jnp.float32)
            err = jnp.square(rad - tgt) * valid
            # local sum; normalized after the psum below
            return jnp.sum(err)

        loss_local, grads = jax.value_and_grad(local_loss)(params)
        # gradient all-reduce over BOTH mesh axes, averaged
        grads = lax.psum(grads, (DATA_AXIS, SAMPLE_AXIS))
        loss = lax.psum(loss_local, (DATA_AXIS, SAMPLE_AXIS))
        denom = jnp.float32(cfg.n_pixels * 3 * n_sample)
        grads = jax.tree_util.tree_map(lambda g: g / denom, grads)
        loss = loss / denom
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if project_fn is not None:
            params = project_fn(params)
        return params, opt_state, loss

    sharded = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params, opt_state, scene, target, key):
        pix, total = _padded_pixels(cfg, n_data, tile)
        tgt = target.reshape(-1, 3)
        pad = total - tgt.shape[0]
        if pad:
            tgt = jnp.concatenate([tgt, jnp.zeros((pad, 3), tgt.dtype)])
        # padding lanes re-render pixel 0 against a zero target; mask
        # them out of the loss by marking their pixel id invalid
        pix_ids = jnp.arange(total, dtype=jnp.int32)
        pix_masked = jnp.where(pix_ids < cfg.n_pixels, pix, -1)
        return sharded(params, opt_state, scene, tgt, pix_masked, key)

    return step
