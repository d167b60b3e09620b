"""Monte-Carlo samplers over splittable counter-based PRNG keys.

The reference keeps one mutable cuRAND state per pixel, re-seeded from
wall-clock time every frame (sampler.h:10-110, path_tracer.cu:34-40,
493-513) -- stateful and nondeterministic. This design instead
derives every random draw from a deterministic (pixel, sample, bounce,
use) key chain with `jax.random` threefry: bit-identical images for a
given key, no state arrays, and trivially shardable because each ray's
stream is independent of scheduling.

All samplers are batched: they take a key array of shape [...] (one key
per ray/lane) produced by `jax.vmap`-free `jax.random.fold_in` chains,
and return arrays with matching leading shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tinypathtracer_tpu.utils.math3d import build_onb

PI = 3.141592653589793


# ---------------------------------------------------------------------------
# Per-lane key plumbing. The renderer derives ONE key per (pixel, sample)
# lane; every consumer of randomness takes raw U[0,1) columns drawn from
# those keys. This makes images bit-identical across any tiling / chunking
# / sharding layout (the draw depends only on the lane's key, never on
# where the lane sits in a batch), which is what makes progressive resume
# and multi-device rendering exact.
# ---------------------------------------------------------------------------

def fold_lanes(key, ids):
    """One key per lane: fold_in(key, ids[i]) vectorized. ids: [N] i32."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(ids)


def fold_all(keys, tag):
    """Fold the same scalar tag into a [N] key array."""
    return jax.vmap(lambda k: jax.random.fold_in(k, tag))(keys)


def lane_uniform(keys, m: int):
    """[N, m] U[0,1) draws, column j of lane i depending only on keys[i]."""
    return jax.vmap(lambda k: jax.random.uniform(k, (m,), dtype=jnp.float32))(keys)


def uniform2(key, shape):
    """Two independent U[0,1) arrays of the given shape from one key."""
    u = jax.random.uniform(key, shape + (2,), dtype=jnp.float32)
    return u[..., 0], u[..., 1]


def hemisphere_cosine_u(u1, u2, normal):
    """Cosine-weighted hemisphere sample around unit `normal` from raw
    uniforms (reference sampler.h:75-89 mapping): phi = 2*pi*u1,
    cos(theta) = sqrt(u2), in the reference's tangent frame
    (utils.math3d.build_onb). pdf = cos(theta)/pi.

    Returns (direction [..., 3], pdf [...]).
    """
    phi = 2.0 * PI * u1
    cos_t = jnp.sqrt(u2)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))
    t, b = build_onb(normal)
    d = (jnp.cos(phi) * sin_t)[..., None] * t \
        + cos_t[..., None] * normal \
        + (jnp.sin(phi) * sin_t)[..., None] * b
    pdf = cos_t / PI
    return d, pdf


def hemisphere_cosine(key, normal):
    """Key-based wrapper over hemisphere_cosine_u."""
    u1, u2 = uniform2(key, normal.shape[:-1])
    return hemisphere_cosine_u(u1, u2, normal)


def hemisphere_uniform_u(u1, u2, normal):
    """Uniform hemisphere sample (reference sampler.h:50-66). pdf = 1/(2*pi).
    Reference draws theta = acos(u1): cos(theta) = u1."""
    cos_t = u1
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * PI * u2
    t, b = build_onb(normal)
    d = (jnp.cos(phi) * sin_t)[..., None] * t \
        + cos_t[..., None] * normal \
        + (jnp.sin(phi) * sin_t)[..., None] * b
    pdf = jnp.full(cos_t.shape, 1.0 / (2.0 * PI), dtype=jnp.float32)
    return d, pdf


def hemisphere_uniform(key, normal):
    """Key-based wrapper over hemisphere_uniform_u."""
    u1, u2 = uniform2(key, normal.shape[:-1])
    return hemisphere_uniform_u(u1, u2, normal)


def coin_flip_u(u, p):
    """Bernoulli(p) from a raw uniform (reference sampler.h:98-101)."""
    return u < p


def coin_flip(key, p):
    """Key-based wrapper over coin_flip_u."""
    u = jax.random.uniform(key, p.shape, dtype=jnp.float32)
    return u < p


def triangle_uniform_u(u1, u2, v0, v1, v2):
    """Uniform point on a triangle (reference sampler.h:30-37)."""
    su = jnp.sqrt(u1)
    a = su * (1.0 - u2)
    b = su * u2
    return a[..., None] * v0 + b[..., None] * v1 + (1.0 - a - b)[..., None] * v2


def triangle_uniform(key, v0, v1, v2):
    """Key-based wrapper over triangle_uniform_u."""
    u1, u2 = uniform2(key, v0.shape[:-1])
    return triangle_uniform_u(u1, u2, v0, v1, v2)
