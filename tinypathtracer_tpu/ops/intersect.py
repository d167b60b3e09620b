"""Batched ray-primitive intersection.

The reference implements per-thread scalar tests (Moller-Trumbore,
geometry_queries.h:66-86; slab AABB test, geometry_queries.h:18-46)
called from a divergent per-ray traversal loop. The formulation here
is dense: a [rays x triangles] tile of simultaneous tests reduced with
min/argmin -- regular, branch-free array work that XLA vectorizes.

`closest_hit_bruteforce` is the exact all-triangles oracle used for
tiny scenes and as ground truth for BVH traversal tests; `ops.traverse`
provides the LBVH-culled version with identical hit semantics:
accept hits with denom != 0, u >= 0, v >= 0, u + v <= 1, and
DELTA < t < best_t (reference path_tracer.cu:81-89).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tinypathtracer_tpu.utils.math3d import DELTA, REAL_MAX, vdot, vcross


def ray_triangle(origins, dirs, v0, v1, v2):
    """Moller-Trumbore for a [N-ray x C-tri] tile.

    origins, dirs: [N, 3]; v0/v1/v2: [C, 3].
    Returns (t [N, C], u [N, C], v [N, C], valid [N, C]).

    Semantics match geometry_queries.h:66-86: no backface culling,
    reject denom == 0, u < 0, v < 0, u + v > 1. The t > DELTA window is
    applied by the caller (as in path_tracer.cu:83).
    """
    e1 = v1 - v0                                     # [C, 3]
    e2 = v2 - v0                                     # [C, 3]
    tvec = origins[:, None, :] - v0[None, :, :]      # [N, C, 3]
    pvec = vcross(dirs[:, None, :], e2[None, :, :])  # [N, C, 3]
    qvec = vcross(tvec, e1[None, :, :])              # [N, C, 3]

    denom = vdot(pvec, e1[None, :, :])               # [N, C]
    inv = jnp.where(denom == 0.0, 0.0, 1.0 / jnp.where(denom == 0.0, 1.0, denom))
    u = vdot(pvec, tvec) * inv
    v = vdot(qvec, dirs[:, None, :]) * inv
    t = vdot(qvec, e2[None, :, :]) * inv
    valid = (denom != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, valid


def ray_aabb(origins, inv_dirs, box_min, box_max):
    """Slab test for a [N-ray x C-box] tile (geometry_queries.h:18-46).

    origins, inv_dirs: [N, 3]; box_min/box_max: [C, 3].
    Returns hit mask [N, C]. Like the reference, the ray is treated as a
    full line (no t >= 0 clip) and degenerate (inf * 0) slabs follow
    IEEE semantics of the reference's multiply.
    """
    t0 = (box_min[None, :, :] - origins[:, None, :]) * inv_dirs[:, None, :]
    t1 = (box_max[None, :, :] - origins[:, None, :]) * inv_dirs[:, None, :]
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    near = jnp.max(tmin, axis=-1)
    far = jnp.min(tmax, axis=-1)
    return near <= far


def closest_hit_bruteforce(origins, dirs, tri_verts, chunk=512, mask=None):
    """Exact closest hit against every triangle.

    origins, dirs: [N, 3]; tri_verts: [F, 3, 3] (face-major world-space
    vertices). Returns (fid [N] i32, t [N], uv [N, 2]); fid == -1 on miss.
    Lanes with mask=False (optional [N] bool) are forced to miss -- the
    oracle computes them anyway; the arg exists for backend-uniform
    results (ops/dense.py skips them).

    Scans face chunks to bound the [N, chunk] working set; the running
    (t, fid, uv) minimum is carried across chunks. Ties on t resolve to
    the lower face id (the reference's traversal order makes ties
    scene-dependent; exact ties are measure-zero for real geometry).
    """
    n = origins.shape[0]
    f = tri_verts.shape[0]
    pad = (-f) % chunk
    tv = jnp.pad(tri_verts, ((0, pad), (0, 0), (0, 0)))
    n_chunks = tv.shape[0] // chunk
    tv = tv.reshape(n_chunks, chunk, 3, 3)
    base_fids = jnp.arange(chunk, dtype=jnp.int32)

    def body(carry, args):
        best_t, best_fid, best_uv = carry
        tris, chunk_idx = args
        fid0 = chunk_idx * chunk
        t, u, v, valid = ray_triangle(origins, dirs, tris[:, 0], tris[:, 1], tris[:, 2])
        in_range = valid & (t > DELTA) & ((fid0 + base_fids)[None, :] < f)
        t = jnp.where(in_range, t, REAL_MAX)
        amin = jnp.argmin(t, axis=1)                      # [N]
        row = jnp.arange(n)
        cand_t = t[row, amin]
        cand_u = u[row, amin]
        cand_v = v[row, amin]
        better = cand_t < best_t
        best_uv = jnp.where(better[:, None],
                            jnp.stack([cand_u, cand_v], axis=-1), best_uv)
        best_fid = jnp.where(better, fid0 + amin.astype(jnp.int32), best_fid)
        best_t = jnp.where(better, cand_t, best_t)
        return (best_t, best_fid, best_uv), None

    init = (
        jnp.full((n,), REAL_MAX, dtype=jnp.float32),
        jnp.full((n,), -1, dtype=jnp.int32),
        jnp.zeros((n, 2), dtype=jnp.float32),
    )
    (best_t, best_fid, best_uv), _ = lax.scan(
        body, init, (tv, jnp.arange(n_chunks, dtype=jnp.int32)))
    if mask is not None:
        best_fid = jnp.where(mask, best_fid, -1)
        best_t = jnp.where(mask, best_t, REAL_MAX)
        best_uv = jnp.where(mask[:, None], best_uv, 0.0)
    return best_fid, best_t, best_uv


def any_hit_bruteforce(origins, dirs, tri_verts, chunk=512):
    """Occlusion query: does any triangle intersect with t > DELTA?

    The reference has no true any-hit: shadow rays reuse full closest-hit
    traversal (path_tracer.cu:277-283). Semantically occlusion only
    needs the boolean, which this computes without the argmin reduction.
    Note: like the reference, there is no max-distance clip -- geometry
    beyond a point light still occludes it (quirk preserved).
    """
    fid, _, _ = closest_hit_bruteforce(origins, dirs, tri_verts, chunk=chunk)
    return fid >= 0


def gather_tri_verts(world_vertices, indices):
    """[F, 3, 3] face-major triangle vertices from shared vertex buffer."""
    return world_vertices[indices]  # [F, 3, 3]
