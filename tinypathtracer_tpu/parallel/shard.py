"""Sharded rendering with shard_map over a ("data", "sample") mesh.

Forward pass: pixels shard over "data", spp shards over "sample", the
scene/BVH pytree is replicated (it is tiny next to the ray state; the
reference's scene also lives whole on its one GPU). The only collective
is a `psum` of the radiance accumulator over the "sample" axis, which
XLA's scheduler can overlap with the tail of the bounce loop. With n_sample == 1 the forward pass is communication-free.

This is the component table's DP / "TP-SP analogue" row (SURVEY.md
par. 2): CUDA grid over pixels -> pixel shards; nothing -> spp shards.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tinypathtracer_tpu.config import RenderConfig
from tinypathtracer_tpu.models.scene import FlatScene
from tinypathtracer_tpu.parallel.mesh import DATA_AXIS, SAMPLE_AXIS
from tinypathtracer_tpu.render import renderer as rend


def _padded_pixels(cfg: RenderConfig, n_data: int, tile: int):
    """Pixel ids padded so each data shard gets a whole number of tiles."""
    n = cfg.n_pixels
    per = -(-n // n_data)
    per = -(-per // tile) * tile
    total = per * n_data
    pix = jnp.arange(total, dtype=jnp.int32)
    # padding lanes re-render pixel 0; discarded on unpad
    return jnp.where(pix < n, pix, 0), total


def render_frame_sharded(scene: FlatScene, cfg: RenderConfig, key, mesh: Mesh):
    """Distributed render_frame. Returns radiance SUM image [H, W, 3].

    Jit-able; the scene pytree is replicated onto every device and each
    (data, sample) submesh cell renders its pixel x spp block.
    """
    n_data = mesh.shape[DATA_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if cfg.spp % n_sample:
        raise ValueError(f"spp={cfg.spp} not divisible by sample axis {n_sample}")
    spp_local = cfg.spp // n_sample

    state = rend.prepare_state(scene, cfg)
    tile = min(cfg.tile_pixels, -(-cfg.n_pixels // n_data))
    pix, total = _padded_pixels(cfg, n_data, tile)

    def per_device(state, pix_shard, key):
        # Each sample shard renders the ABSOLUTE sample range
        # [idx*spp_local, (idx+1)*spp_local): per-lane keys depend only
        # on (pixel, sample) ids, so the psum over shards reproduces the
        # single-device spp sum sample-for-sample (DP sharding stays
        # bit-identical; sample sharding differs only in summation
        # order).
        off = lax.axis_index(SAMPLE_AXIS) * spp_local
        rad = rend.render_pixel_ids(state, cfg, pix_shard, key,
                                    spp=spp_local, sample_offset=off)
        # radiance accumulator all-reduce (the gradient/radiance
        # psum row of SURVEY.md par. 2's parallelism table)
        return lax.psum(rad, SAMPLE_AXIS)

    sharded = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P()),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    rad = sharded(state, pix, key)
    return rad[: cfg.n_pixels].reshape(cfg.height, cfg.width, 3)


def make_sharded_renderer(cfg: RenderConfig, mesh: Mesh):
    """Jitted distributed renderer: fn(scene, key) -> mean image."""

    fn = jax.jit(lambda scene, key: render_frame_sharded(scene, cfg, key, mesh))

    def render(scene: FlatScene, key):
        return fn(scene, key)[::-1, :, :] / cfg.spp

    return render
