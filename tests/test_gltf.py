"""glTF loader + scene flattening tests against the bundled assets.

Counts cross-checked against the reference loader's semantics
(mesh.cu:80-307): primitive 0 per mesh, indices offset into a shared
vertex buffer, MtlInterval face->material LUT, KHR extensions.
"""

import os

import numpy as np
import pytest

from tinypathtracer_tpu import load_scene
from tinypathtracer_tpu.models import gltf

# The reference's glTF scenes (box, ball, square, tir, ...). They are not
# in the repository yet (ROADMAP R1); until they are, these cases fail.
REF = os.path.join(os.path.dirname(__file__), "scenes")


@pytest.fixture(scope="module")
def box_scene():
    return load_scene(f"{REF}/box.gltf")


@pytest.fixture(scope="module")
def ball_scene():
    return load_scene(f"{REF}/ball.gltf")


def test_box_counts(box_scene):
    doc = box_scene.doc
    assert len(doc.meshes) == 8
    total_faces = sum(m.indices.size // 3 for m in doc.meshes)
    total_verts = sum(m.positions.shape[0] for m in doc.meshes)
    assert total_faces == 1932
    assert total_verts == 1142
    assert doc.camera is not None
    assert abs(doc.camera.yfov - 0.39959652046304894) < 1e-9
    assert abs(doc.camera.aspect - 16 / 9) < 1e-3


def test_box_materials(box_scene):
    mats = box_scene.doc.materials
    # glassBall: ior=2 via KHR_materials_ior, transmission -> specular
    glass = mats["glassBall"]
    assert glass.eta == 2.0
    assert abs(glass.specular - (1.0 - 3.0 / 5.0)) < 1e-6
    # squareLIght: emissive strength 6
    assert mats["squareLIght"].emission_factor == 6.0
    # glossyBall: metallicFactor defaults to 1.0 (glTF spec default)
    assert mats["glossyBall"].metallic == 1.0
    # whitWall: explicit metallic 0
    assert mats["whitWall"].metallic == 0.0
    assert np.allclose(mats["whitWall"].base_color, [0.8, 0.8, 0.8], atol=1e-6)


def test_ball_point_light(ball_scene):
    lights = ball_scene.doc.lights
    assert len(lights) == 1
    l = lights[0]
    assert l.kind == "point"
    # candela scaled by watts-per-lumen (reference mesh.cu:276)
    assert abs(l.intensity * 683.0 - 1630.5237) < 0.1


def test_square_spot_light():
    scene = load_scene(f"{REF}/square.gltf")
    (l,) = scene.doc.lights
    assert l.kind == "spot"
    assert 0.0 < l.cos_outer < 1.0
    assert np.isfinite(l.inv_cos_cone_diff)
    # spot points along node -Z transformed to world
    assert abs(np.linalg.norm(l.direction) - 1.0) < 1e-3


def test_flatten_box(box_scene):
    flat = box_scene.flatten()
    F, V, O = 1932, 1142, 8
    assert flat.indices.shape == (F, 3)
    assert flat.vertices.shape == (V, 3)
    assert flat.n_objects == O
    # indices reference the shared buffer within bounds
    idx = np.asarray(flat.indices)
    assert idx.min() >= 0 and idx.max() < V
    # face->material dense map consistent with the interval LUT
    begin = np.asarray(flat.obj_face_begin)
    mtl = np.asarray(flat.obj_mtl_idx)
    fm = np.asarray(flat.face_mtl)
    for f in [0, 100, 500, F - 1]:
        o = np.searchsorted(begin, f, side="right") - 1
        assert fm[f] == mtl[o]
    # per-vertex object ids are monotone over concatenation
    vo = np.asarray(flat.vert_obj)
    assert vo.min() == 0 and vo.max() == O - 1
    assert np.all(np.diff(vo) >= 0)


def test_world_geometry_transforms(box_scene):
    flat = box_scene.flatten()
    wv, wn = flat.world_geometry()
    wv, wn = np.asarray(wv), np.asarray(wn)
    assert np.isfinite(wv).all() and np.isfinite(wn).all()
    # normals are unit length
    assert np.allclose(np.linalg.norm(wn, axis=-1), 1.0, atol=1e-4)
    # Cornell box: world geometry spans roughly [-1, 1] in x
    assert wv[:, 0].min() < -0.9 and wv[:, 0].max() > 0.9
    # the top wall (object 0, translated y+2) reaches y=2
    assert wv[:, 1].max() > 1.9


def test_tir_scene():
    scene = load_scene(f"{REF}/tir.gltf")
    flat = scene.flatten()
    assert flat.n_faces == 6
    # the slab material has ior 2 (KHR_materials_ior)
    assert np.asarray(flat.mtl_eta).max() == 2.0
