"""Scene loading and SoA flattening.

`Scene` is the host-side (numpy) view of a glTF file; `FlatScene` is the
device-resident structure-of-arrays the kernels consume -- the
analogue of the reference's `DeviceScene` (mesh.cuh:80-96) built by
`copySceneToDevice` (mesh.cu:309-397): all meshes concatenated into one
vertex/index buffer with per-object material and transform lookup
tables. Differences from the CUDA layout, chosen for XLA:

  * the face->material interval LUT (mesh.cuh:72-78) is kept, but we
    additionally precompute a dense per-face material id so shading is a
    single gather instead of a per-thread linear search
    (path_tracer.cu:125-135);
  * a dense per-vertex object id replaces the per-face transform lookup
    (path_tracer.cu:227-237) so the local->world transform is one
    batched transform over all vertices;
  * everything is float32/int32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from tinypathtracer_tpu.models import gltf as gltf_mod
from tinypathtracer_tpu.models.camera import Camera
from tinypathtracer_tpu.utils.math3d import (normal_matrix, transform_dirs,
                                            transform_points, trs_to_mat4)


def _resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear-resample [H, W, 3] f32 to [h, w, 3] (atlas layers must
    share one shape)."""
    if img.shape[0] == h and img.shape[1] == w:
        return img.astype(np.float32)
    from PIL import Image

    pil = Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h), Image.BILINEAR),
                      dtype=np.float32) / 255.0

# Light kind codes (order matches reference delta_light.h:9-14)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_SPOT = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FlatScene:
    """Device-side SoA scene. All fields are jnp arrays (a pytree)."""

    # Geometry (local space)
    vertices: jnp.ndarray      # [V, 3] f32
    normals: jnp.ndarray       # [V, 3] f32
    texcoords: jnp.ndarray     # [V, 2] f32
    indices: jnp.ndarray       # [F, 3] i32 (into shared vertex buffer)

    # Per-object tables
    vert_mats: jnp.ndarray     # [O, 4, 4] f32 local->world
    normal_mats: jnp.ndarray   # [O, 4, 4] f32 inverse-transpose
    obj_face_begin: jnp.ndarray  # [O] i32 first face of each object (MtlInterval.begin)
    obj_mtl_idx: jnp.ndarray     # [O] i32 material of each object (MtlInterval.mtlIdx)

    # Dense per-element maps (precomputed from the tables above)
    face_mtl: jnp.ndarray      # [F] i32 material id per face
    vert_obj: jnp.ndarray      # [V] i32 object id per vertex

    # Materials SoA (reference material.h:86-120; only the fields that shade)
    mtl_base_color: jnp.ndarray  # [M, 3] f32
    mtl_emission: jnp.ndarray    # [M] f32 (scalar emission, quirk-compatible)
    mtl_eta: jnp.ndarray         # [M] f32 (0 = non-dielectric)
    mtl_metallic: jnp.ndarray    # [M] f32
    mtl_roughness: jnp.ndarray   # [M] f32
    mtl_specular: jnp.ndarray    # [M] f32

    # Delta lights SoA (reference delta_light.h:96-130 tagged union)
    light_kind: jnp.ndarray      # [L] i32
    light_color: jnp.ndarray     # [L, 3] f32
    light_intensity: jnp.ndarray # [L] f32
    light_pos: jnp.ndarray       # [L, 3] f32
    light_dir: jnp.ndarray       # [L, 3] f32
    light_cos_outer: jnp.ndarray # [L] f32
    light_inv_cone: jnp.ndarray  # [L] f32

    # Environment map, equirect, top row = zenith side (+Y up at v=1).
    env_radiance: jnp.ndarray    # [He, We, 3] f32 in [0, 1] (LDR, /255 like reference)

    # Camera (differentiable leaves: camera gradients flow through these)
    cam_to_world: jnp.ndarray    # [4, 4] f32
    cam_yfov: jnp.ndarray        # [] f32 radians
    cam_aspect: jnp.ndarray      # [] f32
    cam_znear: jnp.ndarray       # [] f32

    # Base-color texture atlas: [T, Ht, Wt, 3] f32 layers (all textures
    # resampled to one shape so the pytree stays static), plus the
    # per-material layer index (-1 = untextured). The reference parses
    # baseColorTexture but never uploads or shades with it (TODOs
    # mesh.cu:155, mesh.cuh:114); this completes that path. A [1,1,1,3]
    # white atlas means "scene has no textures" and the integrator
    # statically skips all texture work (has_textures).
    tex_atlas: jnp.ndarray       # [T, Ht, Wt, 3] f32
    mtl_tex_id: jnp.ndarray      # [M] i32, -1 = none

    @property
    def has_textures(self) -> bool:
        return self.tex_atlas.shape[1] > 1 or self.tex_atlas.shape[2] > 1 \
            or self.tex_atlas.shape[0] > 1

    @property
    def n_faces(self) -> int:
        return self.indices.shape[0]

    @property
    def n_objects(self) -> int:
        return self.vert_mats.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]

    def world_geometry(self):
        """Apply per-object local->world to vertices and normals.

        The replacement of the per-face `transform` kernel
        (path_tracer.cu:239-263): two batched 3x3 transforms driven by a
        per-vertex object-id gather, fully fused by XLA.
        """
        vm = self.vert_mats[self.vert_obj]          # [V, 4, 4]
        nm = self.normal_mats[self.vert_obj]        # [V, 4, 4]
        wv = transform_points(vm, self.vertices)
        wn = transform_dirs(nm, self.normals)
        wn = wn * jax.lax.rsqrt(jnp.sum(wn * wn, axis=-1, keepdims=True))
        return wv, wn


@dataclasses.dataclass
class Scene:
    """Host-side scene: numpy arrays + camera, produced by load_scene."""

    doc: gltf_mod.GltfDocument
    camera: Camera

    def flatten(self, env_radiance: Optional[np.ndarray] = None) -> FlatScene:
        doc = self.doc
        n_obj = len(doc.meshes)
        if n_obj == 0:
            raise ValueError("scene has no meshes")

        # Material name -> index (reference uses std::map iteration order,
        # i.e. sorted by name, mesh.cu:326-333)
        mtl_names = sorted(doc.materials.keys())
        if not mtl_names:
            mtl_names = [""]
            materials = {"": gltf_mod.GltfMaterial(
                name="", base_color=np.array([0.82, 0.67, 0.16]))}
        else:
            materials = doc.materials
        mtl_index = {n: i for i, n in enumerate(mtl_names)}

        verts, norms, uvs, faces = [], [], [], []
        vert_obj, face_mtl = [], []
        obj_face_begin, obj_mtl_idx = [], []
        vert_mats, normal_mats = [], []
        v_off = 0
        f_off = 0
        for oi, mesh in enumerate(doc.meshes):
            nv = mesh.positions.shape[0]
            nf = mesh.indices.shape[0] // 3
            verts.append(mesh.positions)
            norms.append(mesh.normals)
            uvs.append(mesh.texcoords)
            faces.append(mesh.indices.reshape(-1, 3).astype(np.int64) + v_off)
            vert_obj.append(np.full(nv, oi, dtype=np.int32))
            mi = mtl_index.get(mesh.material, 0)
            face_mtl.append(np.full(nf, mi, dtype=np.int32))
            obj_face_begin.append(f_off)
            obj_mtl_idx.append(mi)
            l2w = trs_to_mat4(mesh.translation, mesh.rotation, mesh.scale)
            nm = np.eye(4)
            nm[:3, :3] = normal_matrix(l2w)
            vert_mats.append(l2w)
            normal_mats.append(nm)
            v_off += nv
            f_off += nf

        mtls = [materials[n] for n in mtl_names]
        lights = doc.lights
        n_l = len(lights)

        # Base-color texture atlas: only layers some material actually
        # references, all resampled to one (max) shape so the pytree is
        # static. Untextured scenes get the sentinel [1,1,1,3] white
        # atlas (FlatScene.has_textures == False, zero runtime cost).
        tex_ids = sorted({m.base_color_texture for m in mtls
                          if m.base_color_texture is not None
                          and m.base_color_texture < len(doc.images)})
        if tex_ids:
            imgs = [doc.images[t] for t in tex_ids]
            ah = max(i.shape[0] for i in imgs)
            aw = max(i.shape[1] for i in imgs)
            atlas = np.stack([_resize_image(i, ah, aw) for i in imgs])
            remap = {t: k for k, t in enumerate(tex_ids)}
            mtl_tex_id = [remap.get(m.base_color_texture, -1)
                          if m.base_color_texture is not None else -1
                          for m in mtls]
        else:
            atlas = np.ones((1, 1, 1, 3), np.float32)
            mtl_tex_id = [-1] * len(mtls)

        def f32(x):
            return jnp.asarray(np.asarray(x, dtype=np.float32))

        def i32(x):
            return jnp.asarray(np.asarray(x, dtype=np.int32))

        if env_radiance is None:
            env_radiance = np.zeros((1, 1, 3), dtype=np.float32)

        kind_code = {"point": LIGHT_POINT, "directional": LIGHT_DIRECTIONAL,
                     "spot": LIGHT_SPOT}

        return FlatScene(
            vertices=f32(np.concatenate(verts)),
            normals=f32(np.concatenate(norms)),
            texcoords=f32(np.concatenate(uvs)),
            indices=i32(np.concatenate(faces)),
            vert_mats=f32(np.stack(vert_mats)),
            normal_mats=f32(np.stack(normal_mats)),
            obj_face_begin=i32(obj_face_begin),
            obj_mtl_idx=i32(obj_mtl_idx),
            face_mtl=i32(np.concatenate(face_mtl)),
            vert_obj=i32(np.concatenate(vert_obj)),
            mtl_base_color=f32(np.stack([m.base_color for m in mtls])),
            mtl_emission=f32([m.emission_factor for m in mtls]),
            mtl_eta=f32([m.eta for m in mtls]),
            mtl_metallic=f32([m.metallic for m in mtls]),
            mtl_roughness=f32([m.roughness for m in mtls]),
            mtl_specular=f32([m.specular for m in mtls]),
            light_kind=i32([kind_code[l.kind] for l in lights] if n_l else np.zeros(0)),
            light_color=f32(np.stack([l.color for l in lights]) if n_l
                            else np.zeros((0, 3))),
            light_intensity=f32([l.intensity for l in lights] if n_l else np.zeros(0)),
            light_pos=f32(np.stack([l.position for l in lights]) if n_l
                          else np.zeros((0, 3))),
            light_dir=f32(np.stack([l.direction for l in lights]) if n_l
                          else np.zeros((0, 3))),
            light_cos_outer=f32([l.cos_outer for l in lights] if n_l else np.zeros(0)),
            light_inv_cone=f32([l.inv_cos_cone_diff for l in lights] if n_l
                               else np.zeros(0)),
            env_radiance=f32(env_radiance),
            cam_to_world=f32(self.camera.camera_to_world()),
            cam_yfov=f32(self.camera.yfov),
            cam_aspect=f32(self.camera.aspect),
            cam_znear=f32(self.camera.znear),
            tex_atlas=f32(atlas),
            mtl_tex_id=i32(mtl_tex_id),
        )


def load_scene(path: str) -> Scene:
    """Load a .gltf file into a host-side Scene (reference Scene::Scene)."""
    doc = gltf_mod.read_gltf(path)
    if doc.camera is not None:
        cam = Camera(
            yfov=doc.camera.yfov,
            aspect=doc.camera.aspect,
            znear=doc.camera.znear,
            translation=tuple(doc.camera.translation),
            rotation=tuple(doc.camera.rotation),
            scale=tuple(doc.camera.scale),
        )
    else:
        cam = Camera()
    return Scene(doc=doc, camera=cam)
