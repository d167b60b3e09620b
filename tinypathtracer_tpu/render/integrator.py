"""Path-tracing integrator.

A wavefront redesign of the CUDA megakernel `trace` (path_tracer.cu:296-435).
The reference runs one thread per pixel looping over spp and bounce
depth with per-depth stacks (pStack/mtlIdxStack/directLightStack/
attenuation, path_tracer.cu:315-318) and a backward accumulation pass
(:417-430). Here the bounce loop is a `lax.scan` over a whole ray batch
carrying (origin, dir, throughput, radiance, alive) -- the backward
stack is algebraically folded into a forward throughput product, which
is exactly equivalent:

    backward:  L_d = (direct_d + L_{d+1}) * a_d        (a_d = atten/p)
    forward:   L   = sum_d direct_d * prod_{k<=d} a_k  + terminal * prod a_k

so the forward pass needs no per-depth storage at all (the analogue of
the survey's "scale the big axis without materializing a stack").

Estimator semantics ("reference" mode) -- each quirk kept deliberately
for image parity and gated behind cfg.mode so a physically-correct mode
can coexist:

  * delta-light NEE adds baseColor * incomingRadiance with NO cosine or
    1/pi BRDF factor (path_tracer.cu:281);
  * one extra BSDF-sampled "direct" ray per diffuse bounce adds the raw
    scalar emissionFactor of whatever emissive it hits
    (path_tracer.cu:387-401), with no distance/cos weighting and no env
    contribution on miss;
  * hitting an emissive surface terminates the path and contributes the
    scalar emissionFactor, NOT scaled by that bounce's BSDF
    (path_tracer.cu:408-412, 421-423);
  * miss terminates with the env lookup (path_tracer.cu:358-362);
  * shadow rays use full closest-hit occlusion with no max-distance
    clip: geometry beyond a point light still shadows it
    (path_tracer.cu:277-283).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from tinypathtracer_tpu.config import RenderConfig
from tinypathtracer_tpu.models.envlight import (
    EnvSamplingTables, build_env_tables, env_lookup, sample_env_u)
from tinypathtracer_tpu.models.scene import FlatScene
from tinypathtracer_tpu.ops import bsdf, lights as lights_ops
from tinypathtracer_tpu.ops import shading_c
from tinypathtracer_tpu.ops.sampling import (PI, fold_all, lane_uniform)
from tinypathtracer_tpu.ops.traverse import _ray_tri_single
from tinypathtracer_tpu.utils.math3d import vcross, vdot, vnormalize

# closest_hit(origins [N,3], dirs [N,3], mask=[N] bool or None)
#   -> (fid [N] i32, t [N], uv [N,2]); mask=False lanes report miss and
#   (backend permitting) cost no intersection work.
HitFn = Callable[..., Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TraceData:
    """Per-frame world-space geometry + shading tables (device arrays)."""

    tri_verts: jnp.ndarray     # [F, 3, 3] world-space triangle vertices
    world_normals: jnp.ndarray # [V, 3]
    indices: jnp.ndarray       # [F, 3]
    face_mtl: jnp.ndarray      # [F]
    mtl_base_color: jnp.ndarray
    mtl_emission: jnp.ndarray
    mtl_eta: jnp.ndarray
    mtl_metallic: jnp.ndarray
    light_kind: jnp.ndarray
    light_color: jnp.ndarray
    light_intensity: jnp.ndarray
    light_pos: jnp.ndarray
    light_dir: jnp.ndarray
    light_cos_outer: jnp.ndarray
    light_inv_cone: jnp.ndarray
    env_radiance: jnp.ndarray
    # env importance-sampling tables (models/envlight.py): used by the
    # physical estimator's NEE -- the machinery the reference built but
    # never called (env_light.cuh:58-70)
    env_marginal_cdf: jnp.ndarray
    env_conditional_cdf: jnp.ndarray
    env_pdf: jnp.ndarray
    # Fused per-face shading table [F, 15] (+6 texcoord cols when the
    # scene is textured): corner normals (9), base color (3), emission
    # (1), eta (1), metallic (1) [, corner texcoords (6)]. One row
    # fetch per bounce replaces ~12 separate gathers. Fetches go
    # through `fetch_cols` (an EXACT one-hot matmul for small tables;
    # whether a plain gather is faster on the GPU is an open
    # measurement, ROADMAP S5). Triangle VERTICES are deliberately NOT in the pack:
    # the primal consumes the intersector's own (t, u, v) and the
    # Moller-Trumbore recompute (which needs the verts) runs only in
    # the backward pass (_hit_surface), so the 9-wide vert fetch is
    # grad-time-only.
    # TRANSPOSED [S, F]: the bounce loop is component-form (see
    # ops/shading_c.py), so the per-bounce fetch produces [S, N] and
    # component rows slice out as contiguous rows.
    shade_packT: jnp.ndarray
    face_emission: jnp.ndarray   # [F] emission only, for cheap lookups
    # flattened env channels [H*W] (component-form miss shading)
    env_r: jnp.ndarray
    env_g: jnp.ndarray
    env_b: jnp.ndarray
    # base-color texturing (completes the reference's TODO at
    # mesh.cu:155 / mesh.cuh:114): per-face atlas layer (-1 = none) and
    # the atlas itself ([1,1,1,3] sentinel = scene has no textures; the
    # integrator then skips texture work at trace time)
    face_tex: jnp.ndarray        # [F] i32
    tex_atlas: jnp.ndarray       # [T, Ht, Wt, 3] f32
    # flattened atlas channels [T*Ht*Wt] (component-form texel fetch)
    atlas_r: jnp.ndarray
    atlas_g: jnp.ndarray
    atlas_b: jnp.ndarray
    # Mip chain of the atlas, one flat array per channel (levels
    # concatenated; static offsets from texture.mip_level_shapes).
    # Consumed by cfg.tex_filter == "bilinear" (distance/ray-spread LOD
    # + bilinear fetch -- the filtering the reference's mip chain was
    # built for but never configured, texture.cu:90-170).
    atlas_mips_r: jnp.ndarray
    atlas_mips_g: jnp.ndarray
    atlas_mips_b: jnp.ndarray
    # [F] per-face uv-density sqrt(uv_area / world_area): texels/pixel
    # ~= t * pixel_angle * duv * tex_height drives the LOD pick
    face_duv: jnp.ndarray
    # 2 * tan(yfov / 2): vertical view extent per unit distance (divide
    # by cfg.height for the per-pixel ray spread)
    cam_spread: jnp.ndarray
    # Emissive-triangle NEE tables (physical mode): per-face world area,
    # power-weighted sampling cdf over ALL faces (zero-power faces get
    # zero mass; no static emissive subset needed), and the total power
    # W = sum(emission * area). The area-light machinery the reference
    # estimator approximates with its extra BSDF-sampled direct ray
    # (path_tracer.cu:387-401) -- here done properly with MIS.
    face_area: jnp.ndarray       # [F]
    em_cdf: jnp.ndarray          # [F] inclusive cdf of emission*area
    em_power: jnp.ndarray        # [] sum of emission*area

    @staticmethod
    def from_scene(scene: FlatScene) -> "TraceData":
        from tinypathtracer_tpu.models.texture import build_atlas_mips

        wv, wn = scene.world_geometry()
        tables = build_env_tables(scene.env_radiance)
        tri_verts = wv[scene.indices]
        corner_n = wn[scene.indices]                       # [F, 3, 3]
        f = scene.indices.shape[0]
        face_emission = scene.mtl_emission[scene.face_mtl]
        mips = build_atlas_mips(scene.tex_atlas)
        if scene.has_textures:
            cuv = scene.texcoords[scene.indices]           # [F, 3, 2]
            e1w = tri_verts[:, 1] - tri_verts[:, 0]
            e2w = tri_verts[:, 2] - tri_verts[:, 0]
            area_w = 0.5 * jnp.linalg.norm(vcross(e1w, e2w), axis=1)
            e1u = cuv[:, 1] - cuv[:, 0]
            e2u = cuv[:, 2] - cuv[:, 0]
            area_u = 0.5 * jnp.abs(e1u[:, 0] * e2u[:, 1]
                                   - e1u[:, 1] * e2u[:, 0])
            face_duv = jnp.sqrt(area_u / jnp.maximum(area_w, 1e-20))
        else:
            face_duv = jnp.zeros((f,), jnp.float32)
        e1 = tri_verts[:, 1] - tri_verts[:, 0]
        e2 = tri_verts[:, 2] - tri_verts[:, 0]
        face_area = 0.5 * jnp.linalg.norm(vcross(e1, e2), axis=1)
        em_w = face_emission * face_area
        em_cdf = jnp.cumsum(em_w)
        em_power = em_cdf[-1] if f > 0 else jnp.float32(0.0)
        cols = [
            corner_n.reshape(f, 9),
            scene.mtl_base_color[scene.face_mtl],
            face_emission[:, None],
            scene.mtl_eta[scene.face_mtl][:, None],
            scene.mtl_metallic[scene.face_mtl][:, None],
        ]
        if scene.has_textures:
            cols.append(scene.texcoords[scene.indices].reshape(f, 6))
        shade_packT = jnp.concatenate(cols, axis=1).T
        env_flat = scene.env_radiance.reshape(-1, 3)
        return TraceData(
            tri_verts=tri_verts,
            world_normals=wn,
            indices=scene.indices,
            face_mtl=scene.face_mtl,
            mtl_base_color=scene.mtl_base_color,
            mtl_emission=scene.mtl_emission,
            mtl_eta=scene.mtl_eta,
            mtl_metallic=scene.mtl_metallic,
            light_kind=scene.light_kind,
            light_color=scene.light_color,
            light_intensity=scene.light_intensity,
            light_pos=scene.light_pos,
            light_dir=scene.light_dir,
            light_cos_outer=scene.light_cos_outer,
            light_inv_cone=scene.light_inv_cone,
            env_radiance=scene.env_radiance,
            env_marginal_cdf=tables.marginal_cdf,
            env_conditional_cdf=tables.conditional_cdf,
            env_pdf=tables.pdf,
            shade_packT=shade_packT,
            face_emission=face_emission,
            env_r=env_flat[:, 0], env_g=env_flat[:, 1], env_b=env_flat[:, 2],
            face_tex=scene.mtl_tex_id[scene.face_mtl],
            tex_atlas=scene.tex_atlas,
            atlas_r=scene.tex_atlas[..., 0].reshape(-1),
            atlas_g=scene.tex_atlas[..., 1].reshape(-1),
            atlas_b=scene.tex_atlas[..., 2].reshape(-1),
            atlas_mips_r=mips[0],
            atlas_mips_g=mips[1],
            atlas_mips_b=mips[2],
            face_duv=face_duv,
            cam_spread=2.0 * jnp.tan(0.5 * scene.cam_yfov),
            face_area=face_area,
            em_cdf=em_cdf,
            em_power=em_power,
        )


@jax.custom_vjp
def fetch_cols(tableT, idx):
    """EXACT column fetch [S, F][:, idx] -> [S, N] for small tables, as
    a one-hot matmul in HIGHEST precision (exact for f32 because the
    one-hot side is exactly representable). Falls back to the plain
    gather for tables too large to one-hot against (one-hot cost scales
    with F). Which form is faster on the GPU is ROADMAP S5.

    custom-vjp so the [F, N] one-hot NEVER enters the autodiff graph as
    a residual: the backward rebuilds it from idx and runs the
    transpose dot (the exact gradient).
    """
    f = tableT.shape[1]
    if f > 8192:
        return tableT[:, idx]
    oh = (jnp.arange(f, dtype=idx.dtype)[:, None] == idx[None, :]).astype(
        tableT.dtype)
    return jnp.dot(tableT, oh, precision=lax.Precision.HIGHEST)


def _fetch_cols_fwd(tableT, idx):
    return fetch_cols(tableT, idx), (tableT.shape[1], idx)


def _fetch_cols_bwd(res, ct):
    f, idx = res
    if f > 8192:
        gt = jnp.zeros((ct.shape[0], f), ct.dtype).at[:, idx].add(ct)
    else:
        oh = (jnp.arange(f, dtype=idx.dtype)[:, None]
              == idx[None, :]).astype(ct.dtype)            # [F, N]
        gt = jnp.dot(ct, oh.T, precision=lax.Precision.HIGHEST)
    return gt, None


fetch_cols.defvjp(_fetch_cols_fwd, _fetch_cols_bwd)


@jax.custom_vjp
def _gather_1d(table, idx):
    """table[idx] for a 1-D table, with a MATMUL gradient: the one-hot
    transpose-dot replaces the plain gather's scatter-add VJP for small
    tables (ROADMAP S5 measures which is faster on the GPU). Forward
    stays the plain gather."""
    return table[idx]


def _gather_1d_fwd(table, idx):
    return table[idx], (table.shape[0], idx)


def _gather_1d_bwd(res, ct):
    f, idx = res
    if f > 16384:
        gt = jnp.zeros((f,), ct.dtype).at[idx].add(ct)
    else:
        oh = (jnp.arange(f, dtype=idx.dtype)[None, :]
              == idx[:, None]).astype(ct.dtype)          # [N, F]
        gt = jnp.dot(ct[None, :], oh,
                     precision=lax.Precision.HIGHEST)[0]
    return gt, None


_gather_1d.defvjp(_gather_1d_fwd, _gather_1d_bwd)


@jax.custom_vjp
def _hit_surface(o, d, tri_verts, fid, t_k, u_k, v_k):
    """Forward the intersector's own (t, u, v) as primal hit data;
    route gradients through a Moller-Trumbore recompute that runs ONLY
    in the backward pass (path-replay convention: the hit id is
    non-differentiable, the surface point is). This keeps the 9-wide
    vertex fetch and the MT arithmetic out of the primal bounce."""
    return t_k, u_k, v_k


def _hit_surface_fwd(o, d, tri_verts, fid, t_k, u_k, v_k):
    return (t_k, u_k, v_k), (o, d, tri_verts, fid)


def _hit_surface_bwd(res, cts):
    o, d, tri_verts, fid = res
    f_count = tri_verts.shape[0]
    fid_c = jnp.maximum(fid, 0)
    live = (fid >= 0)
    # Small scenes fetch the hit triangles AND scatter their gradients
    # back via one-hot matmuls (exact in HIGHEST precision) instead of
    # a gather/scatter pair (ROADMAP S5).
    small = f_count <= 8192
    if small:
        oh = (jnp.arange(f_count, dtype=fid.dtype)[:, None]
              == fid_c[None, :]).astype(jnp.float32)      # [F, N]
        tv = jnp.dot(tri_verts.reshape(f_count, 9).T, oh,
                     precision=lax.Precision.HIGHEST)     # [9, N]
        tv = tv.T.reshape(-1, 3, 3)
    else:
        tv = tri_verts[fid_c]

    def f(o_, d_, tv_):
        t, u, v, _ok = _ray_tri_single(o_, d_, tv_[:, 0], tv_[:, 1],
                                       tv_[:, 2])
        return t, u, v

    _, vjp = jax.vjp(f, o, d, tv)
    # zero the cotangents of miss lanes BEFORE the vjp touches the
    # degenerate recompute (t against face 0 is garbage there)
    cts = tuple(jnp.where(live, c, 0.0) for c in cts)
    go, gd, gtv = vjp(cts)
    gtv = jnp.where(live[:, None, None], gtv, 0.0)
    if small:
        gtv_full = jnp.dot(gtv.reshape(-1, 9).T, oh.T,
                           precision=lax.Precision.HIGHEST)
        gtv_full = gtv_full.T.reshape(f_count, 3, 3)
    else:
        gtv_full = jnp.zeros_like(tri_verts).at[fid_c].add(gtv)
    zero = jnp.zeros_like(cts[0])
    return (go, gd, gtv_full, None, zero, zero, zero)


_hit_surface.defvjp(_hit_surface_fwd, _hit_surface_bwd)


def _direct_light(data: TraceData, cfg: RenderConfig, hit_pos, base_color,
                  any_hit: HitFn, live):
    """Delta-light NEE (reference sampleDeltaLights, path_tracer.cu:265-286).

    One shadow ray per light per lane; the light count is static so the
    loop unrolls into L independent masked occlusion queries. Only
    `live` lanes trace (dead lanes' contributions are discarded by the
    caller's mask anyway).
    """
    n = hit_pos.shape[0]
    direct = jnp.zeros((n, 3), dtype=jnp.float32)
    n_lights = data.light_kind.shape[0]
    for li in range(n_lights):
        wi, lrad, _dist = lights_ops.sample_delta_light(
            hit_pos, data.light_kind[li], data.light_color[li],
            data.light_intensity[li], data.light_pos[li], data.light_dir[li],
            data.light_cos_outer[li], data.light_inv_cone[li])
        # Occlusion is purely combinatorial: detach it from autodiff
        # so while_loop-based backends never see tangents.
        fid, _t, _uv = any_hit(lax.stop_gradient(hit_pos),
                               lax.stop_gradient(wi), mask=live)
        unoccluded = fid < 0
        contrib = base_color * lrad
        direct = direct + jnp.where(unoccluded[:, None], contrib, 0.0)
    return direct


def trace_paths(data: TraceData, cfg: RenderConfig, closest_hit: HitFn,
                origins, dirs, lane_keys):
    """Trace a batch of rays to completion; returns radiance [N, 3].

    lane_keys: [N] PRNG key array, one per ray lane (the renderer folds
    (pixel, sample) ids into the frame key). All randomness inside a
    bounce is drawn from per-lane keys, so results are independent of
    how lanes are batched/tiled/sharded.

    One scan step == one bounce for ALL rays (dead lanes are masked,
    wavefront compaction comes in at the traversal layer where it pays).
    """
    n = origins.shape[0]

    def hit_query(o, d, mask):
        """Closest hit with the discrete traversal fully detached from
        autodiff: backends may be while_loop-based and must never see
        tangents. Returns the backend's (fid, t, uv) under
        stop_gradient; differentiability of the surface point is
        restored by _hit_surface (custom-vjp MT recompute in the
        backward pass only -- path-replay convention, SURVEY.md par. 7
        hard part 2)."""
        return jax.tree_util.tree_map(
            lax.stop_gradient, closest_hit(lax.stop_gradient(o),
                                           lax.stop_gradient(d),
                                           mask=mask))

    # The bounce loop is COMPONENT-FORM: every per-lane quantity is a
    # plain [N] array (vectors as three components). See
    # ops/shading_c.py.
    def bounce(state, depth):
        (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb,
         alive, prev_spec, prev_pdf) = state
        # One uniform block per bounce from per-lane keys: cols 0-1 BSDF
        # hemisphere, 2 BSDF Fresnel coin; in reference mode cols 3-4
        # are the extra direct-sample hemisphere and 5 its coin; in
        # physical mode cols 3-4 drive env NEE, 5 RR, 6 the emissive-
        # face pick and 7-8 its surface point (area NEE).
        u = lane_uniform(fold_all(lane_keys, depth),
                         9 if cfg.mode == "physical" else 6)

        o3 = jnp.stack([ox, oy, oz], axis=1)
        d3 = jnp.stack([dx, dy, dz], axis=1)
        fid, t_k, uv_k = hit_query(o3, d3, alive)
        miss = fid < 0

        # Terminal: environment on miss (path_tracer.cu:358-362). In
        # physical mode, diffuse bounces already account for the dome
        # via env NEE below, so only camera/specular paths collect it
        # here (prev_spec starts True).
        eh, ew = data.env_radiance.shape[0], data.env_radiance.shape[1]
        etex = shading_c.env_texel_c(eh, ew, dx, dy, dz)
        count_env = (alive & miss) if cfg.mode == "reference" \
            else (alive & miss & prev_spec)
        er = jnp.where(count_env,
                       _gather_1d(data.env_r, etex) * cfg.env_scale, 0.0)
        eg = jnp.where(count_env,
                       _gather_1d(data.env_g, etex) * cfg.env_scale, 0.0)
        eb = jnp.where(count_env,
                       _gather_1d(data.env_b, etex) * cfg.env_scale, 0.0)
        rr = rr + tr * er
        rg = rg + tg * eg
        rb = rb + tb * eb

        # Primal (t, u, v) from the intersector itself; gradients via
        # the backward-only MT recompute. Keep miss lanes finite.
        t_k = jnp.where(miss, 1.0, t_k)
        t, u_, v_ = _hit_surface(o3, d3, data.tri_verts, fid,
                                 t_k, uv_k[:, 0], uv_k[:, 1])
        w_ = 1.0 - u_ - v_
        packT = fetch_cols(data.shade_packT, jnp.maximum(fid, 0))  # [S, N]
        nx = (w_ * packT[0] + u_ * packT[3]) + v_ * packT[6]
        ny = (w_ * packT[1] + u_ * packT[4]) + v_ * packT[7]
        nz = (w_ * packT[2] + u_ * packT[5]) + v_ * packT[8]
        nx, ny, nz = shading_c.normalize_c(nx, ny, nz, eps=1e-20)
        hx = ox + t * dx
        hy = oy + t * dy
        hz = oz + t * dz

        br, bg_, bb = packT[9], packT[10], packT[11]
        emission = packT[12]
        eta = packT[13]
        metallic = packT[14]

        # Base-color texture modulation (shape-static skip for
        # untextured scenes). Point-sampled with wrap addressing,
        # matching the reference's cudaFilterModePoint texture objects
        # (texture.cu:129-170); glTF uv origin is top-left so v maps to
        # rows directly. Texel gradients flow through the gather.
        if (data.tex_atlas.shape[0] > 1 or data.tex_atlas.shape[1] > 1
                or data.tex_atlas.shape[2] > 1):
            th, tw = data.tex_atlas.shape[1], data.tex_atlas.shape[2]
            ut = lax.stop_gradient(
                (w_ * packT[15] + u_ * packT[17]) + v_ * packT[19])
            vt = lax.stop_gradient(
                (w_ * packT[16] + u_ * packT[18]) + v_ * packT[20])
            tid = data.face_tex[jnp.maximum(fid, 0)]
            textured = tid >= 0
            if cfg.tex_filter == "bilinear":
                # Distance/ray-spread mip LOD + bilinear filtering
                # through the atlas mip chain. Per-lane level: the
                # chain is stored FLAT (texture.build_atlas_mips), so a
                # level's offset/shape are gathered scalars and the
                # whole fetch stays vectorized -- no lax.switch.
                # texels/pixel ~= t * pixel_angle * duv * tex_height.
                from tinypathtracer_tpu.models.texture import \
                    mip_level_shapes

                shapes = mip_level_shapes(th, tw)
                n_tex = data.tex_atlas.shape[0]
                offs, acc = [], 0
                for (hl_, wl_) in shapes:
                    offs.append(acc)
                    acc += n_tex * hl_ * wl_
                hs = jnp.asarray([s[0] for s in shapes], jnp.int32)
                ws = jnp.asarray([s[1] for s in shapes], jnp.int32)
                off_t = jnp.asarray(offs, jnp.int32)
                duv = data.face_duv[jnp.maximum(fid, 0)]
                px_angle = data.cam_spread / cfg.height
                # Primary-ray footprint approximation: uses this
                # bounce's hit distance t and the camera pixel angle
                # even on secondary bounces, underestimating the ray
                # spread after diffuse scattering (over-sharp indirect
                # lookups). Accumulating path distance in the carry
                # would fix it; kept simple since "bilinear" is already
                # a beyond-parity extension (ADVICE r4).
                texels_px = lax.stop_gradient(t) * px_angle * duv * th
                lodf = jnp.log2(jnp.maximum(texels_px, 1e-20))
                lvl = jnp.clip(jnp.floor(lodf).astype(jnp.int32),
                               0, len(shapes) - 1)
                hl = hs[lvl]
                wl = ws[lvl]
                off = off_t[lvl]
                uu = jnp.mod(ut, 1.0) * wl.astype(jnp.float32) - 0.5
                vv = jnp.mod(vt, 1.0) * hl.astype(jnp.float32) - 0.5
                x0 = jnp.floor(uu)
                y0 = jnp.floor(vv)
                fx = uu - x0
                fy = vv - y0
                x0i = x0.astype(jnp.int32)
                y0i = y0.astype(jnp.int32)
                x0w = jnp.mod(x0i, wl)
                x1w = jnp.mod(x0i + 1, wl)
                y0w = jnp.mod(y0i, hl)
                y1w = jnp.mod(y0i + 1, hl)
                lay = off + jnp.maximum(tid, 0) * (hl * wl)
                i00 = lay + y0w * wl + x0w
                i10 = lay + y0w * wl + x1w
                i01 = lay + y1w * wl + x0w
                i11 = lay + y1w * wl + x1w
                w00 = (1.0 - fx) * (1.0 - fy)
                w10 = fx * (1.0 - fy)
                w01 = (1.0 - fx) * fy
                w11 = fx * fy

                def bilin(ch):
                    return (w00 * ch[i00] + w10 * ch[i10]
                            + w01 * ch[i01] + w11 * ch[i11])

                tex_r = bilin(data.atlas_mips_r)
                tex_g = bilin(data.atlas_mips_g)
                tex_b = bilin(data.atlas_mips_b)
            else:
                tx = jnp.clip((jnp.mod(ut, 1.0) * tw).astype(jnp.int32),
                              0, tw - 1)
                ty = jnp.clip((jnp.mod(vt, 1.0) * th).astype(jnp.int32),
                              0, th - 1)
                flat_idx = (jnp.maximum(tid, 0) * (th * tw) + ty * tw + tx)
                tex_r = data.atlas_r[flat_idx]
                tex_g = data.atlas_g[flat_idx]
                tex_b = data.atlas_b[flat_idx]
            br = br * jnp.where(textured, tex_r, 1.0)
            bg_ = bg_ * jnp.where(textured, tex_g, 1.0)
            bb = bb * jnp.where(textured, tex_b, 1.0)

        # Terminal: emissive hit contributes the raw scalar emission
        # (path_tracer.cu:408-412, 421-423)
        emissive = emission > 0.0
        hit_em = jnp.where(alive & ~miss & emissive, emission, 0.0)
        if cfg.mode == "physical" and cfg.area_nee:
            # MIS against area NEE: this hit could also have been found
            # by the emissive-face sampler below, with solid-angle pdf
            # p_nee = (emission / W) * t^2 / cos_light. prev_pdf == 0
            # marks camera / specular predecessors (NEE never samples
            # those paths -> full weight). Balance heuristic.
            w_power = lax.stop_gradient(data.em_power)
            # geometric normal of the hit face: the NEE sampler's pdf
            # below uses it too, so the two balance weights of a given
            # path sum to exactly 1 (consistent measures)
            tv_h = lax.stop_gradient(data.tri_verts[jnp.maximum(fid, 0)])
            ng = vcross(tv_h[:, 1] - tv_h[:, 0], tv_h[:, 2] - tv_h[:, 0])
            ng = ng / jnp.maximum(
                jnp.linalg.norm(ng, axis=1, keepdims=True), 1e-20)
            cos_l = jnp.abs(dx * ng[:, 0] + dy * ng[:, 1] + dz * ng[:, 2])
            p_nee = jnp.where(
                w_power > 0.0,
                (lax.stop_gradient(emission) / jnp.maximum(w_power, 1e-20))
                * t * t / jnp.maximum(cos_l, 1e-8),
                0.0)
            w_mis = jnp.where(prev_pdf > 0.0,
                              prev_pdf / jnp.maximum(prev_pdf + p_nee,
                                                     1e-20),
                              1.0)
            hit_em = hit_em * lax.stop_gradient(w_mis)
        rr = rr + tr * hit_em
        rg = rg + tg * hit_em
        rb = rb + tb * hit_em

        live = alive & ~miss & ~emissive

        # BSDF bounce: weight = baseColor * atten/p (path_tracer.cu:379-380)
        ndx, ndy, ndz, ratio, is_spec = shading_c.sample_bsdf_c(
            u[:, 0], u[:, 1], u[:, 2], dx, dy, dz, nx, ny, nz,
            eta, metallic)
        wr, wg, wb = br * ratio, bg_ * ratio, bb * ratio

        if cfg.mode == "reference":
            # Extra direct-emitter sample for non-specular materials
            # (path_tracer.cu:387-401): a second BSDF draw; if it hits
            # anything, add that material's scalar emissionFactor.
            # do_extra lanes are exactly the diffuse-lobe lanes, so the
            # draw is the cosine hemisphere directly (bit-identical to
            # the full BSDF sample on those lanes, half the work).
            do_extra = ~((eta >= 1.0) | (metallic > 0.0))
            sgn = jnp.where(
                shading_c.dot_c(dx, dy, dz, nx, ny, nz) > 0.0, -1.0, 1.0)
            d2x, d2y, d2z, _pdf2 = shading_c.hemisphere_cosine_c(
                u[:, 3], u[:, 4], nx * sgn, ny * sgn, nz * sgn)
            h3 = jnp.stack([hx, hy, hz], axis=1)
            d23 = jnp.stack([d2x, d2y, d2z], axis=1)
            fid2, _t2, _uv2 = closest_hit(lax.stop_gradient(h3),
                                          lax.stop_gradient(d23),
                                          mask=live & do_extra)
            em2 = _gather_1d(data.face_emission, jnp.maximum(fid2, 0))
            em2 = jnp.where((fid2 >= 0) & do_extra, em2, 0.0)
            dr = dg = db = em2
            # Delta-light NEE (quirk: no cos / BRDF weighting)
            if data.light_kind.shape[0] > 0:
                b3 = jnp.stack([br, bg_, bb], axis=1)
                direct3 = _direct_light(data, cfg, h3, b3, closest_hit,
                                        live)
                dr = dr + direct3[:, 0]
                dg = dg + direct3[:, 1]
                db = db + direct3[:, 2]
            # direct_d enters weighted by prod_{k<=d} a_k = thr * weight
            # (the estimator folds this bounce's BSDF into the direct
            # term -- an exact transcription of path_tracer.cu:427)
            lv = live
            rr = rr + jnp.where(lv, tr * wr * dr, 0.0)
            rg = rg + jnp.where(lv, tg * wg * dg, 0.0)
            rb = rb + jnp.where(lv, tb * wb * db, 0.0)
        else:
            # Physical NEE on diffuse lanes: f = albedo/pi, weighted by
            # cos(theta); specular lanes skip NEE (delta BSDF). This
            # branch keeps the readable [N, 3] formulation (it is the
            # correctness-mode path, not the benched one).
            sgn = jnp.where(
                shading_c.dot_c(dx, dy, dz, nx, ny, nz) > 0.0, -1.0, 1.0)
            n_side = jnp.stack([nx * sgn, ny * sgn, nz * sgn], axis=1)
            hit_pos = jnp.stack([hx, hy, hz], axis=1)
            base_color = jnp.stack([br, bg_, bb], axis=1)
            thr3 = jnp.stack([tr, tg, tb], axis=1)
            f_diff = base_color / PI
            diffuse = live & ~is_spec
            direct = jnp.zeros((n, 3), dtype=jnp.float32)
            for li in range(data.light_kind.shape[0]):
                wi, lrad, _dist = lights_ops.sample_delta_light(
                    hit_pos, data.light_kind[li], data.light_color[li],
                    data.light_intensity[li], data.light_pos[li],
                    data.light_dir[li], data.light_cos_outer[li],
                    data.light_inv_cone[li])
                cos_l = jnp.maximum(vdot(wi, n_side), 0.0)
                ofid, _t_, _u_ = closest_hit(lax.stop_gradient(hit_pos),
                                             lax.stop_gradient(wi),
                                             mask=diffuse)
                direct = direct + jnp.where((ofid < 0)[:, None],
                                            f_diff * (cos_l * 1.0)[:, None] * lrad,
                                            0.0)
            # Env-light importance sampling wired into NEE (the
            # reference built these tables but never called them,
            # env_light.cuh:58-70 / SURVEY.md par. 2)
            wi_e, pdf_e = sample_env_u(
                u[:, 3:5],
                EnvSamplingTables(marginal_cdf=data.env_marginal_cdf,
                                  conditional_cdf=data.env_conditional_cdf,
                                  pdf=data.env_pdf))
            cos_e = jnp.maximum(vdot(wi_e, n_side), 0.0)
            efid, _t2_, _u2_ = closest_hit(lax.stop_gradient(hit_pos),
                                           lax.stop_gradient(wi_e),
                                           mask=diffuse)
            env_e = env_lookup(data.env_radiance, wi_e) * cfg.env_scale
            w_env = jnp.where(pdf_e > 0.0, cos_e / jnp.maximum(pdf_e, 1e-12), 0.0)
            direct = direct + jnp.where((efid < 0)[:, None],
                                        f_diff * w_env[:, None] * env_e, 0.0)
            if cfg.area_nee:
                # Emissive-triangle NEE with MIS (the correct version of
                # the reference's extra direct ray, path_tracer.cu:
                # 387-401): pick a face by power (searchsorted inverse-
                # cdf over ALL faces; zero-power faces carry zero mass),
                # a uniform point on it, one shadow closest-hit, then
                # weight by the balance heuristic against the diffuse
                # BSDF pdf. Sampling distribution is detached (path-
                # replay); the radiance term stays differentiable.
                from tinypathtracer_tpu.ops.sampling import \
                    triangle_uniform_u

                cdf = lax.stop_gradient(data.em_cdf)
                w_power = cdf[-1]
                fsel = jnp.clip(
                    jnp.searchsorted(cdf, u[:, 6] * w_power),
                    0, data.tri_verts.shape[0] - 1).astype(jnp.int32)
                tv_s = data.tri_verts[fsel]                  # [N, 3, 3]
                y = triangle_uniform_u(u[:, 7], u[:, 8],
                                       tv_s[:, 0], tv_s[:, 1], tv_s[:, 2])
                d_vec = lax.stop_gradient(y) - hit_pos
                dist2 = jnp.maximum(vdot(d_vec, d_vec), 1e-12)
                dist = jnp.sqrt(dist2)
                wi_a = d_vec / dist[:, None]
                n_s = vcross(tv_s[:, 1] - tv_s[:, 0], tv_s[:, 2] - tv_s[:, 0])
                n_s = n_s / jnp.maximum(
                    jnp.linalg.norm(n_s, axis=1, keepdims=True), 1e-20)
                cos_x = jnp.maximum(vdot(wi_a, n_side), 0.0)
                cos_y = jnp.abs(vdot(wi_a, lax.stop_gradient(n_s)))
                em_s = data.face_emission[fsel]
                want = diffuse & (w_power > 0.0) & (em_s > 0.0)
                sfid, _ts, _us = closest_hit(lax.stop_gradient(hit_pos),
                                             lax.stop_gradient(wi_a),
                                             mask=want)
                visible = want & (sfid == fsel)
                p_area = lax.stop_gradient(em_s) / jnp.maximum(w_power,
                                                               1e-20)
                # balance heuristic vs the cosine-lobe BSDF pdf
                p_nee_w = p_area * dist2 / jnp.maximum(cos_y, 1e-8)
                w_mis = lax.stop_gradient(
                    p_nee_w / jnp.maximum(p_nee_w + cos_x / PI, 1e-20))
                amt = (em_s * cos_x * cos_y
                       / (dist2 * jnp.maximum(p_area, 1e-20))) * w_mis
                direct = direct + jnp.where(visible[:, None],
                                            f_diff * amt[:, None], 0.0)
            drad = jnp.where(diffuse[:, None], thr3 * direct, 0.0)
            rr = rr + drad[:, 0]
            rg = rg + drad[:, 1]
            rb = rb + drad[:, 2]

        tr = jnp.where(live, tr * wr, tr)
        tg = jnp.where(live, tg * wg, tg)
        tb = jnp.where(live, tb * wb, tb)
        ox = jnp.where(live, hx, ox)
        oy = jnp.where(live, hy, oy)
        oz = jnp.where(live, hz, oz)
        dx = jnp.where(live, ndx, dx)
        dy = jnp.where(live, ndy, dy)
        dz = jnp.where(live, ndz, dz)
        prev_spec = jnp.where(live, is_spec, prev_spec)
        if cfg.mode == "physical":
            # solid-angle pdf of the diffuse draw (0 marks specular /
            # dead: the emissive-hit MIS above gives those full weight).
            # n_side is the incident-side normal from the NEE block
            # (computed with the PRE-update direction).
            nd3 = jnp.stack([ndx, ndy, ndz], axis=1)
            cos_nd = jnp.maximum(vdot(nd3, n_side), 0.0)
            pdf_draw = jnp.where(is_spec, 0.0, cos_nd / PI)
            prev_pdf = jnp.where(live, lax.stop_gradient(pdf_draw),
                                 prev_pdf)

        # Russian roulette (physical mode only; not part of the
        # reference estimator)
        if cfg.mode == "physical" and cfg.russian_roulette:
            p_sur = jnp.clip(jnp.maximum(jnp.maximum(tr, tg), tb), 0.05, 1.0)
            late = depth >= 3
            u_rr = u[:, 5]
            kill = live & late & (u_rr >= p_sur)
            scale = jnp.where(live & late, 1.0 / p_sur, 1.0)
            tr, tg, tb = tr * scale, tg * scale, tb * scale
            live = live & ~kill

        return (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb,
                live, prev_spec, prev_pdf), None

    ones = jnp.ones((n,), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)
    init = (
        origins[:, 0], origins[:, 1], origins[:, 2],
        dirs[:, 0], dirs[:, 1], dirs[:, 2],
        ones, ones, ones,
        zeros, zeros, zeros,
        jnp.ones((n,), dtype=bool),
        jnp.ones((n,), dtype=bool),   # prev_spec: camera rays see the env
        zeros,                        # prev_pdf: 0 = camera/specular
    )
    # Rematerialize each bounce in the backward pass: reverse-mode
    # through the plain scan would save every bounce's internals --
    # including the [F, N] one-hot of fetch_cols, F * N * 4 bytes per
    # bounce (~7 GB at 1.8k faces and a 1M-ray chunk). With checkpointing only the [N]-sized carries persist; the bounce
    # recomputes from them during backward (path-replay: identical
    # randomness by key, so the replay is exact).
    xs = jnp.arange(cfg.max_depth, dtype=jnp.int32)
    out, _ = lax.scan(jax.checkpoint(bounce), init, xs)
    rr, rg, rb = out[9], out[10], out[11]
    return jnp.stack([rr, rg, rb], axis=1)
