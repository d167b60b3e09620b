"""Environment (dome) light: equirectangular radiance map + sampling tables.

Reference: env_light.cu / env_light.cuh + texture.cu. The CUDA version
decodes a JPG with FreeImage into a uint8 CUDA texture and evaluates it
only on ray miss (path_tracer.cu:288-294, 358-362); it also builds a
luminance CDF for importance sampling that is never wired into the
integrator (env_light.cuh:58-70). Here:

  * the map is a plain [H, W, 3] float32 array in [0, 1] (LDR /255 like
    the reference) or genuinely HDR if loaded from .npy/.exr-like data;
  * miss lookup is a pure gather (point sample, like the reference's
    cudaFilterModePoint texture);
  * the marginal/conditional CDF tables are built with jnp.cumsum and
    inverted with searchsorted, and ARE wired into the physical-mode
    integrator's NEE (finishing what the reference started).

Direction convention (env_light.cuh:72-78): +Y is up; u = atan2(z, x) /
2pi wrapped to [0, 1); v = 1 - acos(y)/pi, so v=1 is the zenith. Images
are stored top-down with row 0 = zenith side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from tinypathtracer_tpu.ops.sampling import PI


def load_env_image(path: str) -> np.ndarray:
    """Decode an image file to [H, W, 3] float32 in [0, 1] (top-down rows).

    LDR formats go through PIL (uint8 / 255, matching the reference's
    FreeImage+uint8-texture path, texture.cu:64-102); .npy arrays are
    taken as-is (HDR-capable).
    """
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim != 3 or arr.shape[2] < 3:
            raise ValueError(f"expected [H, W, 3] array in {path}")
        return np.ascontiguousarray(arr[:, :, :3])
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def gradient_sky(height: int = 64, width: int = 128,
                 horizon=(0.8, 0.75, 0.7), zenith=(0.25, 0.45, 0.85)) -> np.ndarray:
    """Procedural sky dome used when no env image asset is available
    (the repo's reference assets are missing their large env-map blobs).
    """
    t = np.linspace(1.0, 0.0, height)[:, None, None]  # 1 at zenith row 0
    sky = t * np.asarray(zenith)[None, None, :] + (1 - t) * np.asarray(horizon)[None, None, :]
    return np.broadcast_to(sky, (height, width, 3)).astype(np.float32)


def dir_to_uv(dirs):
    """[N, 3] directions -> equirect (u, v) in [0,1) (env_light.cuh:72-78)."""
    u = jnp.arctan2(dirs[..., 2], dirs[..., 0]) / (2.0 * PI)
    u = jnp.where(u < 0.0, u + 1.0, u)
    v = 1.0 - jnp.arccos(jnp.clip(dirs[..., 1], -1.0, 1.0)) / PI
    return u, v


def env_lookup(env_radiance, dirs):
    """Point-sample the dome for a batch of directions (miss shading).

    env_radiance: [H, W, 3] (row 0 = zenith side). dirs: [N, 3] unit.
    Returns [N, 3]. Matches reference sampleEnvLights
    (path_tracer.cu:288-294): nearest-texel fetch, no filtering.
    """
    h, w = env_radiance.shape[0], env_radiance.shape[1]
    # Texel selection is discrete: detach it so arccos'(+-1) = inf can
    # never reach reverse-mode (gradients still flow to the map values
    # through the gather).
    u, v = dir_to_uv(jax.lax.stop_gradient(dirs))
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip(((1.0 - v) * h).astype(jnp.int32), 0, h - 1)
    # single flat index into the [H*W, 3] table
    return env_radiance.reshape(-1, 3)[row * w + col]


@dataclasses.dataclass
class EnvSamplingTables:
    """Row-marginal + per-row-conditional CDFs for importance sampling."""

    marginal_cdf: jnp.ndarray     # [H] inclusive scan of row weights
    conditional_cdf: jnp.ndarray  # [H, W] inclusive scan within rows
    pdf: jnp.ndarray              # [H, W] solid-angle pdf of sampling texel


def build_env_tables(env_radiance) -> EnvSamplingTables:
    """Luminance * sin(theta) sampling tables.

    The reference weights by theta instead of sin(theta)
    (env_light.cu:17-18) -- a variance bug in machinery it never calls;
    we use the correct solid-angle weight.
    """
    h, w = env_radiance.shape[0], env_radiance.shape[1]
    luma = (0.2126 * env_radiance[..., 0] + 0.7152 * env_radiance[..., 1]
            + 0.0722 * env_radiance[..., 2])
    # row 0 is the zenith side (v=1 <-> theta=0)
    theta = (jnp.arange(h, dtype=jnp.float32) + 0.5) * (PI / h)
    weights = luma * jnp.sin(theta)[:, None] + 1e-12
    row_sum = jnp.sum(weights, axis=1)                    # [H]
    marginal_cdf = jnp.cumsum(row_sum)
    total = marginal_cdf[-1]
    conditional_cdf = jnp.cumsum(weights, axis=1)         # [H, W]
    # pdf over solid angle: p(texel) / (solid angle of texel)
    texel_sa = (2.0 * PI / w) * (PI / h) * jnp.sin(theta)[:, None]
    pdf = (weights / total) / jnp.maximum(texel_sa, 1e-12)
    return EnvSamplingTables(marginal_cdf=marginal_cdf,
                             conditional_cdf=conditional_cdf, pdf=pdf)


def sample_env_u(u, tables: EnvSamplingTables):
    """Draw directions ~ luminance of the dome from raw uniforms u [n, 2].

    Returns (dirs [n, 3], pdf [n]) with pdf in solid-angle measure.
    Inverse-CDF via searchsorted (the batched replacement of the reference's
    hand-rolled device binary search, env_light.cuh:46-56).
    """
    h = tables.marginal_cdf.shape[0]
    w = tables.conditional_cdf.shape[1]
    total = tables.marginal_cdf[-1]
    row = jnp.searchsorted(tables.marginal_cdf, u[:, 0] * total)
    row = jnp.clip(row, 0, h - 1)
    row_cdf = tables.conditional_cdf[row]                 # [n, W]
    row_total = row_cdf[:, -1]
    col = jax.vmap(jnp.searchsorted)(row_cdf, u[:, 1] * row_total)
    col = jnp.clip(col, 0, w - 1)
    theta = (row.astype(jnp.float32) + 0.5) * (PI / h)
    phi = (col.astype(jnp.float32) + 0.5) * (2.0 * PI / w)
    sin_t = jnp.sin(theta)
    dirs = jnp.stack([sin_t * jnp.cos(phi), jnp.cos(theta), sin_t * jnp.sin(phi)],
                     axis=-1)
    pdf = tables.pdf[row, col]
    return dirs, pdf


def sample_env(key, tables: EnvSamplingTables, n: int):
    """Key-based wrapper over sample_env_u (tests / standalone use)."""
    u = jax.random.uniform(key, (n, 2), dtype=jnp.float32)
    return sample_env_u(u, tables)
