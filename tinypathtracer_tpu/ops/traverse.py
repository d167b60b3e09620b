"""BVH traversal for ray batches: the large-scene intersector.

The reference's per-thread stackful traversal (`traverseBVH`,
path_tracer.cu:61-107) as a lockstep walk: ALL rays advance one node
per step -- the traversal state (per-ray stack + running best hit)
lives in SoA arrays and each step is a handful of per-lane gathers plus
batched box/triangle tests. The `lax.while_loop` runs until every
lane's stack is empty, so wall time is set by the deepest ray, and
dead (masked) lanes start with an empty stack.

`renderer.resolve_intersector` routes "dense" requests above
DENSE_MAX_FACES here: on an H100 this walk's cost grows far slower
with the face count than the dense sweep's (PERF.md). It is also the
oracle that validates the LBVH build (ops/lbvh.py, csrc native
builder): tests cross-check its hits against brute force.

Differences from the reference, same results, strictly less work:

  * the reference's slab test treats rays as infinite lines and ignores
    the running best hit (geometry_queries.h:18-46) -- here boxes behind
    the origin (far < DELTA) or beyond the current best (near > best_t)
    are culled; triangle acceptance (DELTA < t < best) is unchanged, so
    closest hits are identical;
  * both children are tested in one batched box test and pushed
    left-then-right (pop order matches path_tracer.cu:95-104).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax

from tinypathtracer_tpu.ops.lbvh import BVH, build_lbvh
from tinypathtracer_tpu.utils.math3d import DELTA, REAL_MAX

build_bvh = build_lbvh


def _ray_box(o, inv_d, bmin, bmax, t_max):
    """Batched slab test with [DELTA, t_max] clipping. All args [N, ...]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (far >= jnp.maximum(near, DELTA)) & (near <= t_max)


def _ray_tri_single(o, d, v0, v1, v2):
    """Moller-Trumbore, one triangle per ray lane ([N, 3] everywhere)."""
    e1 = v1 - v0
    e2 = v2 - v0
    tvec = o - v0
    pvec = jnp.cross(d, e2)
    qvec = jnp.cross(tvec, e1)
    denom = jnp.sum(pvec * e1, axis=-1)
    inv = jnp.where(denom == 0.0, 0.0, 1.0 / jnp.where(denom == 0.0, 1.0, denom))
    u = jnp.sum(pvec * tvec, axis=-1) * inv
    v = jnp.sum(qvec * d, axis=-1) * inv
    t = jnp.sum(qvec * e2, axis=-1) * inv
    ok = (denom != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def closest_hit_bvh(origins, dirs, bvh: BVH, stack_depth: int = 32,
                    mask=None):
    """Closest hit via lockstep stack traversal.

    origins, dirs: [N, 3]. Returns (fid [N] i32 (-1 = miss), t [N],
    uv [N, 2]) with semantics identical to closest_hit_bruteforce.
    Lanes with mask=False (optional [N] bool) start with an empty stack:
    they do no traversal work and report miss (dead-lane compaction).
    """
    n = origins.shape[0]
    f = bvh.n_faces
    n_leaf_base = f - 1  # node >= this is a leaf (path_tracer.cu:73)

    inv_d = jnp.where(dirs == 0.0, REAL_MAX, 1.0 / jnp.where(dirs == 0.0, 1.0, dirs))

    stack = jnp.zeros((n, stack_depth), jnp.int32)  # [:, 0] holds root 0
    sp = jnp.ones((n,), jnp.int32)
    if mask is not None:
        sp = jnp.where(mask, sp, 0)

    init = (
        stack, sp,
        jnp.full((n,), REAL_MAX, jnp.float32),   # best_t
        jnp.full((n,), -1, jnp.int32),            # best_fid
        jnp.zeros((n, 2), jnp.float32),           # best_uv
    )

    def cond(state):
        _, sp, _, _, _ = state
        return jnp.any(sp > 0)

    def step(state):
        stack, sp, best_t, best_fid, best_uv = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(n), top]
        sp = jnp.where(active, sp - 1, sp)

        is_leaf = node >= n_leaf_base

        # --- leaf: one triangle test per lane ---
        leaf_idx = jnp.clip(node - n_leaf_base, 0, f - 1)
        fid = bvh.leaf_fid[leaf_idx]
        tri = bvh.tri_verts[fid]                          # [N, 3, 3]
        t, u, v, ok = _ray_tri_single(origins, dirs, tri[:, 0], tri[:, 1], tri[:, 2])
        take = active & is_leaf & ok & (t > DELTA) & (t < best_t)
        best_uv = jnp.where(take[:, None], jnp.stack([u, v], -1), best_uv)
        best_fid = jnp.where(take, fid, best_fid)
        best_t = jnp.where(take, t, best_t)

        # --- internal: test both children, push hits ---
        node_i = jnp.clip(node, 0, n_leaf_base - 1) if n_leaf_base > 0 else node
        lc = bvh.left[node_i]
        rc = bvh.right[node_i]
        hit_l = _ray_box(origins, inv_d, bvh.bmin[lc], bvh.bmax[lc], best_t)
        hit_r = _ray_box(origins, inv_d, bvh.bmin[rc], bvh.bmax[rc], best_t)
        intern = active & ~is_leaf

        push_l = intern & hit_l
        rows = jnp.arange(n)
        slot = jnp.minimum(sp, stack_depth - 1)
        stack = stack.at[rows, slot].set(
            jnp.where(push_l, lc, stack[rows, slot]))
        sp = jnp.where(push_l, jnp.minimum(sp + 1, stack_depth), sp)

        push_r = intern & hit_r
        slot = jnp.minimum(sp, stack_depth - 1)
        stack = stack.at[rows, slot].set(
            jnp.where(push_r, rc, stack[rows, slot]))
        sp = jnp.where(push_r, jnp.minimum(sp + 1, stack_depth), sp)

        return stack, sp, best_t, best_fid, best_uv

    _, _, best_t, best_fid, best_uv = lax.while_loop(cond, step, init)
    return best_fid, best_t, best_uv
