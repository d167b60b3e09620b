"""Dense ray x triangle closest-hit: every ray against every triangle.

For scenes of a few thousand faces, testing all (ray, triangle) pairs
as regular arithmetic with no data-dependent control flow beats a tree
walk (`traverseBVH`, path_tracer.cu:61-107): the trip count is known at
compile time, nothing diverges, and all per-triangle work is hoisted
out of the hot loop.

  * `precompute_woop` re-expresses each triangle as Woop's unit-triangle
    affine transform [Woop et al. 2013-style]: rows of M^-1 for
    M = [e1 e2 n], so a hit test becomes
        o' = W o + c,  d' = W d,
        t = -o'_z / d'_z,  u = o'_x + t d'_x,  v = o'_y + t d'_y,
        hit iff u >= 0, v >= 0, u + v <= 1, DELTA < t.
    That is ~21 fused multiply-adds, one division and a few compares per
    (ray, tri) pair -- vs ~60 operations for inline Moller-Trumbore.
    Triangles are stored as 12 component planes [12, Fp] (rows
    wx0..wx3, wy0..wy3, wz0..wz3) in morton order of their centroids.

  * `closest_hit_dense` runs the test as a Pallas kernel through Triton
    on the GPU (`_dense_triton`): one program per block of rays keeps
    its rays and a lane-local running best (t, slot, u, v) in registers
    and streams triangle tiles past them, so no [rays x faces]
    intermediate ever reaches device memory. Every other platform runs
    `_dense_xla`, the plain version: variadic min-reductions over small
    face tiles.

Hit semantics match `closest_hit_bruteforce` (ops/intersect.py), i.e.
the reference's acceptance rules (geometry_queries.h:66-86 +
path_tracer.cu:81-89): no backface culling, degenerate triangles and
padding never hit, ties on t resolve to the lowest morton slot. Both
versions compute each pair with the same operations in the same order
and reduce under the same total order on (t, slot), so they agree bit
for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tinypathtracer_tpu.utils.math3d import DELTA, REAL_MAX, vcross, vdot

# Faces are padded to a multiple of this, so every triangle tile of the
# kernel is whole (BLOCK_TRIS must divide it).
FACE_QUANTUM = 256
# Kernel tiling, tuned on an H100 (PERF.md): rays per program, triangles
# per inner-loop step, and the Triton launch parameters.
BLOCK_RAYS = 32
BLOCK_TRIS = 32
NUM_WARPS = 4
NUM_STAGES = 2
# Faces per reduction step of the plain version: XLA keeps one [N, tile]
# f32 array per step in memory (below), so the tile bounds it (1 GiB at
# 1M rays); on an H100 smaller tiles cost no time at 61k faces (PERF.md).
XLA_TILE = 256

_I32_MAX = 2**31 - 1  # plain int: jnp scalars would be captured consts in Pallas


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WoopTris:
    """Triangles as unit-triangle transforms, component-plane layout.

    planes: [12, Fp] f32, faces in morton order of their centroids. Row
    4*c + k (c in x/y/z, k in 0..2) holds W[c, k] of the matrix that
    maps world to unit-triangle space; row 4*c + 3 holds the affine
    offset -(W v0)_c. Padding and degenerate faces are all-zero columns,
    which the hit test rejects (t evaluates to NaN).

    perm: [Fp] i32, morton slot -> ORIGINAL face id (intersection
    results must be mapped through this before touching face tables).
    """

    planes: jnp.ndarray
    perm: jnp.ndarray
    n_faces: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def n_padded(self) -> int:
        return self.planes.shape[1]


def precompute_woop(tri_verts) -> WoopTris:
    """[F, 3, 3] world-space triangles -> WoopTris.

    Runs inside the jitted frame (tri_verts is per-frame world geometry,
    cf. the reference's per-frame `transform` kernel feeding the BVH
    rebuild, path_tracer.cu:536-542); cost is O(F log F) for the morton
    sort, negligible next to tracing.
    """
    from tinypathtracer_tpu.ops.lbvh import morton30

    f = tri_verts.shape[0]
    fb_min = jnp.min(tri_verts, axis=1)            # [F, 3]
    fb_max = jnp.max(tri_verts, axis=1)
    cent = 0.5 * (fb_min + fb_max)
    codes = morton30(cent, jnp.min(fb_min, axis=0), jnp.max(fb_max, axis=0))
    order = jnp.argsort(codes).astype(jnp.int32)   # stable: ties keep file order
    tv = tri_verts[order]

    v0 = tv[:, 0]
    e1 = tv[:, 1] - v0
    e2 = tv[:, 2] - v0
    n = vcross(e1, e2)
    det = vdot(n, n)[:, None]                      # det([e1 e2 n]) = |n|^2
    ok = det > 0.0
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    # rows of M^-1 for M = [e1 e2 n] (columns): cross-product adjugate
    r0 = vcross(e2, n) * inv
    r1 = vcross(n, e1) * inv
    r2 = n * inv
    w = jnp.stack([r0, r1, r2], axis=1)            # [F, 3(row), 3(col)]
    # elementwise, not a matmul: no TF32 and no platform-dependent sum order
    c = -(w[:, :, 0] * v0[:, 0:1] + w[:, :, 1] * v0[:, 1:2]
          + w[:, :, 2] * v0[:, 2:3])               # [F, 3]
    planes = jnp.concatenate([w, c[:, :, None]], axis=2)  # [F, 3, 4]
    pad = (-f) % FACE_QUANTUM
    planes = jnp.pad(planes, ((0, pad), (0, 0), (0, 0)))
    planes = planes.reshape(-1, 12).T              # [12, Fp]
    perm = jnp.pad(order, (0, pad))
    return WoopTris(planes=planes, perm=perm, n_faces=f)


def _hit_test(o, d, w, best_t):
    """The per-pair Woop test shared by both versions.

    o, d: three ray components each ([N, 1]); w: twelve plane rows each
    ([1, T]). Returns (t, u, v, ok), each [N, T]. Division is a plain
    `/` in both versions: on an H100 that gives identical bits, while
    an exact `div.rn.f32` in the kernel differed from XLA's division in
    the last bit (PERF.md).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    opx = ox * w[0] + oy * w[1] + oz * w[2] + w[3]
    opy = ox * w[4] + oy * w[5] + oz * w[6] + w[7]
    opz = ox * w[8] + oy * w[9] + oz * w[10] + w[11]
    dpx = dx * w[0] + dy * w[1] + dz * w[2]
    dpy = dx * w[4] + dy * w[5] + dz * w[6]
    dpz = dx * w[8] + dy * w[9] + dz * w[10]
    t = -opz / dpz               # inf/NaN on parallel/degenerate: rejected below
    u = opx + t * dpx
    v = opy + t * dpy
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA) & (t < best_t)
    return t, u, v, ok


def _dense_kernel(rays_ref, planes_ref, t_ref, slot_ref, u_ref, v_ref, *,
                  n_tiles: int, block_tris: int):
    """One program: a block of rays against every triangle tile.

    The running best is LANE-LOCAL ([rays, block_tris] per quantity), so
    the hot loop has no cross-thread work; one cross-lane argmin per
    ray block runs at the end. Strict '<' updates keep the earliest
    tile per lane and the final reduce takes the lowest slot among
    equal-t lanes, so the lowest morton slot wins overall.
    """
    o = tuple(rays_ref[k, :][:, None] for k in range(3))
    d = tuple(rays_ref[k, :][:, None] for k in range(3, 6))
    shape = (o[0].shape[0], block_tris)
    lane = lax.broadcasted_iota(jnp.int32, shape, 1)

    def body(j, best):
        bt, bs, bu, bv = best
        lo = pl.multiple_of(j * block_tris, block_tris)
        w = [planes_ref[k, pl.ds(lo, block_tris)][None, :] for k in range(12)]
        t, u, v, ok = _hit_test(o, d, w, bt)
        return (jnp.where(ok, t, bt), jnp.where(ok, lo + lane, bs),
                jnp.where(ok, u, bu), jnp.where(ok, v, bv))

    init = (jnp.full(shape, REAL_MAX, jnp.float32),
            jnp.zeros(shape, jnp.int32),
            jnp.zeros(shape, jnp.float32),
            jnp.zeros(shape, jnp.float32))
    bt, bs, bu, bv = lax.fori_loop(0, n_tiles, body, init)
    m = jnp.min(bt, axis=1)
    on_min = bt == m[:, None]
    slot = jnp.min(jnp.where(on_min, bs, _I32_MAX), axis=1)
    win = on_min & (bs == slot[:, None])
    t_ref[...] = m
    slot_ref[...] = slot
    u_ref[...] = jnp.max(jnp.where(win, bu, -REAL_MAX), axis=1)
    v_ref[...] = jnp.max(jnp.where(win, bv, -REAL_MAX), axis=1)


@functools.partial(jax.jit, static_argnames=(
    "block_rays", "block_tris", "num_warps", "num_stages", "interpret"))
def _dense_triton(rays, planes, block_rays: int = BLOCK_RAYS,
                  block_tris: int = BLOCK_TRIS, num_warps: int = NUM_WARPS,
                  num_stages: int = NUM_STAGES, interpret: bool = False):
    """rays: [8, N] (origin xyz, dir xyz, 2 zero rows that make the
    block's row count a power of two); planes: [12, Fp].

    Returns (t, slot, u, v), each [N]; t == REAL_MAX marks a miss (slot,
    u, v are then meaningless).
    """
    n = rays.shape[1]
    fp = planes.shape[1]
    if fp % block_tris:
        raise ValueError(f"padded faces {fp} are not a multiple of the "
                         f"triangle tile {block_tris}")
    pad = (-n) % block_rays
    rays_p = jnp.pad(rays, ((0, 0), (0, pad)))
    np_ = rays_p.shape[1]
    row = pl.BlockSpec((block_rays,), lambda i: (i,))
    out = jax.ShapeDtypeStruct((np_,), jnp.float32)
    t, slot, u, v = pl.pallas_call(
        functools.partial(_dense_kernel, n_tiles=fp // block_tris,
                          block_tris=block_tris),
        grid=(np_ // block_rays,),
        in_specs=[pl.BlockSpec((8, block_rays), lambda i: (0, i)),
                  pl.BlockSpec((12, fp), lambda i: (0, 0))],
        out_specs=(row, row, row, row),
        out_shape=(out, jax.ShapeDtypeStruct((np_,), jnp.int32), out, out),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="dense_closest_hit",
    )(rays_p, planes)
    return t[:n], slot[:n], u[:n], v[:n]


_REDUCE_INIT = (np.float32(np.inf), np.int32(_I32_MAX), np.float32(0.0),
                np.float32(0.0))


def _argmin_t_slot(a, b):
    """Variadic-reduce combiner: lower t wins, ties go to the lower slot."""
    ta, sa, ua, va = a
    tb, sb, ub, vb = b
    take_a = (ta < tb) | ((ta == tb) & (sa < sb))
    return (jnp.where(take_a, ta, tb), jnp.where(take_a, sa, sb),
            jnp.where(take_a, ua, ub), jnp.where(take_a, va, vb))


@jax.jit
def _dense_xla(rays, planes):
    """Plain twin of `_dense_triton`: same arguments, same results.

    A scan over tiles of XLA_TILE faces; in each, one variadic reduction
    over the face axis carries (t, slot, u, v) of the winner. XLA fuses
    the rest of the hit test into the reduce but computes the division
    `t` in a fusion of its own, so one [N, tile] array per step reaches
    device memory; nothing [N, Fp]-sized does.
    """
    n = rays.shape[1]
    tile = min(XLA_TILE, planes.shape[1])
    planes = jnp.pad(planes, ((0, 0), (0, (-planes.shape[1]) % tile)))
    n_tiles = planes.shape[1] // tile
    o = tuple(rays[k][:, None] for k in range(3))
    d = tuple(rays[k][:, None] for k in range(3, 6))

    def body(best, j):
        pw = lax.dynamic_slice_in_dim(planes, j * tile, tile, axis=1)
        w = [pw[k][None, :] for k in range(12)]
        t, u, v, ok = _hit_test(o, d, w, REAL_MAX)
        tc = jnp.where(ok, t, REAL_MAX)
        slots = j * tile + lax.broadcasted_iota(jnp.int32, (n, tile), 1)
        part = lax.reduce((tc, slots, u, v), _REDUCE_INIT, _argmin_t_slot,
                          (1,))
        return _argmin_t_slot(best, part), None

    init = tuple(jnp.full((n,), x) for x in _REDUCE_INIT)
    best, _ = lax.scan(body, init, jnp.arange(n_tiles, dtype=jnp.int32))
    return best


def closest_hit_dense(origins, dirs, woop: WoopTris, mask=None):
    """Closest hit against all triangles. origins/dirs: [N, 3].

    Returns (fid [N] i32 (-1 = miss), t [N] f32, uv [N, 2] f32). The
    winner's (t, u, v) are the integrator's primal hit data; gradients
    route through a custom-vjp Moller-Trumbore recompute that only runs
    in the backward pass (render/integrator._hit_surface).

    The kernel is chosen when the program is lowered: the Triton kernel
    for CUDA devices, `_dense_xla` elsewhere.

    mask ([N] bool, optional) is SEMANTICS ONLY: lanes with mask=False
    report miss, but every lane is still tested.
    """
    n = origins.shape[0]
    rays = jnp.concatenate(
        [origins.T, dirs.T, jnp.zeros((2, n), origins.dtype)], axis=0)
    t, slot, u, v = lax.platform_dependent(
        rays, woop.planes, cuda=_dense_triton, default=_dense_xla)
    # padding can't win (its t is NaN), but be safe
    hit = (t < REAL_MAX) & (slot < woop.n_faces)
    if mask is not None:
        hit = hit & mask
    fid = jnp.where(hit, woop.perm[jnp.where(hit, slot, 0)], -1)
    t = jnp.where(hit, t, REAL_MAX)
    uv = jnp.where(hit[:, None], jnp.stack([u, v], axis=1), 0.0)
    return fid, t, uv
