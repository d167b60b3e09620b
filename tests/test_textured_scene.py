"""Base-color textures wired into shading (reference TODO mesh.cu:155,
mesh.cuh:114 -- parsed but never uploaded there; completed here).

Builds a minimal in-memory glTF: one textured quad facing the camera,
with a 2x2 checkerboard PNG embedded as a data URI. Under the
reference estimator with a constant white env dome and depth 2, a
diffuse surface's pixel color is (base_color * texel) * E[env], so the
image IS the texture (up to noise).
"""

import base64
import io
import json
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu import RenderConfig, Renderer
from tinypathtracer_tpu.models import gltf as gltf_mod
from tinypathtracer_tpu.models.scene import Scene
from tinypathtracer_tpu.models.camera import Camera

CHECKER = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                    [[0.0, 0.0, 1.0], [1.0, 1.0, 1.0]]], np.float32)


def _png_data_uri(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((img * 255).astype(np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def _textured_quad_gltf(tmp_path):
    """Quad spanning [-1,1]^2 at z=-2, uv covering the full texture."""
    pos = np.array([[-1, -1, -2], [1, -1, -2], [1, 1, -2], [-1, 1, -2]],
                   np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    # glTF uv origin is top-left: v=0 at the TOP of the texture
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode(),
                     "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 32},
            {"buffer": 0, "byteOffset": 128, "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "images": [{"uri": _png_data_uri(CHECKER)}],
        "textures": [{"source": 0}],
        "materials": [{"name": "checker",
                       "pbrMetallicRoughness": {
                           "baseColorFactor": [1, 1, 1, 1],
                           "baseColorTexture": {"index": 0},
                           "metallicFactor": 0.0}}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.9, "aspectRatio": 1.0,
                                     "znear": 0.01}}],
        "nodes": [{"mesh": 0}, {"camera": 0}],
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    }
    path = tmp_path / "quad.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture(scope="module")
def quad_flat(tmp_path_factory):
    path = _textured_quad_gltf(tmp_path_factory.mktemp("tex"))
    scene = gltf_mod.read_gltf(path)
    from tinypathtracer_tpu import load_scene

    sc = load_scene(path)
    return sc.flatten(env_radiance=np.ones((4, 8, 3), np.float32))


def test_atlas_built(quad_flat):
    assert quad_flat.has_textures
    assert quad_flat.tex_atlas.shape == (1, 2, 2, 3)
    assert int(quad_flat.mtl_tex_id[0]) == 0
    np.testing.assert_allclose(np.asarray(quad_flat.tex_atlas[0]), CHECKER,
                               atol=1 / 255.0)


def test_textured_render_shows_checker(quad_flat):
    cfg = RenderConfig(width=32, height=32, spp=16, max_depth=2,
                       intersector="dense")
    img = np.asarray(Renderer(cfg).render(quad_flat, jax.random.PRNGKey(0)))
    # image rows are top-down; quad covers the center of the frame.
    # sample one point well inside each texel quadrant
    q = {}
    q["tl"] = img[9, 9]      # top-left of IMAGE = uv (0,0) = texel row 0
    q["tr"] = img[9, 22]
    q["bl"] = img[22, 9]
    q["br"] = img[22, 22]
    for k, v in q.items():
        assert v.max() > 0.05, f"{k} is black: {v}"

    def hue(v):
        return int(np.argmax(v))

    # CHECKER rows: top = [red, green], bottom = [blue, white]
    assert hue(q["tl"]) == 0          # red
    assert hue(q["tr"]) == 1          # green
    assert hue(q["bl"]) == 2          # blue
    w = q["br"]
    assert w.std() / (w.mean() + 1e-9) < 0.25   # whiteish


def test_untextured_scene_is_static_noop(make_room):
    flat = make_room(env=(4, 8))
    assert not flat.has_textures
    assert flat.tex_atlas.shape == (1, 1, 1, 3)
    assert (np.asarray(flat.mtl_tex_id) == -1).all()


def test_texel_gradients_match_fd(quad_flat):
    from tinypathtracer_tpu.diff.invrender import Params, mse_loss

    cfg = RenderConfig(width=12, height=12, spp=4, max_depth=2,
                       intersector="dense", tile_pixels=144)
    key = jax.random.PRNGKey(5)
    target = jnp.zeros((12, 12, 3), jnp.float32)
    params = Params.from_scene(quad_flat)

    loss = lambda p: mse_loss(p, quad_flat, cfg, target, key)
    g = jax.grad(loss)(params).tex_atlas
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0, "no gradient reached the texels"

    # central finite differences on two texel channels
    eps = 2e-3
    for (t, y, x, c) in [(0, 0, 0, 0), (0, 1, 1, 2)]:
        atlas_p = params.tex_atlas.at[t, y, x, c].add(eps)
        atlas_m = params.tex_atlas.at[t, y, x, c].add(-eps)
        lp = loss(Params(**{**params.__dict__, "tex_atlas": atlas_p}))
        lm = loss(Params(**{**params.__dict__, "tex_atlas": atlas_m}))
        fd = (float(lp) - float(lm)) / (2 * eps)
        np.testing.assert_allclose(g[t, y, x, c], fd, rtol=5e-2, atol=1e-5)


# ---------------------------------------------------------------------------
# Round-4: mip LOD + bilinear filtering (cfg.tex_filter == "bilinear")
# ---------------------------------------------------------------------------

def test_mip_chain_content():
    from tinypathtracer_tpu.models.texture import (build_atlas_mips,
                                                   mip_level_shapes)

    atlas = jnp.asarray(CHECKER)[None]                     # [1, 2, 2, 3]
    shapes = mip_level_shapes(2, 2)
    assert shapes == [(2, 2), (1, 1)]
    mr, mg, mb = build_atlas_mips(atlas)
    assert mr.shape == (2 * 2 + 1,)
    # level 0 = the checker itself, level 1 = point decimation = texel
    # (0, 0) = red (texture.cu:15-31 upper-left semantics)
    np.testing.assert_allclose(np.asarray(mr[:4]),
                               CHECKER[..., 0].reshape(-1))
    np.testing.assert_allclose(np.asarray([mr[4], mg[4], mb[4]]),
                               CHECKER[0, 0])


def test_bilinear_blends_at_quad_center(quad_flat):
    import dataclasses as dc

    cfg = RenderConfig(width=32, height=32, spp=16, max_depth=2,
                       intersector="dense", tex_filter="bilinear")
    img = np.asarray(Renderer(cfg).render(quad_flat, jax.random.PRNGKey(0)))
    # uv (0.5, 0.5) bilinearly blends all four texels of the 2x2 checker
    # -> equal channels (grey), unlike the point fetch which lands in a
    # single saturated texel
    c = img[15:17, 15:17].reshape(-1, 3).mean(axis=0)
    assert c.std() / (c.mean() + 1e-9) < 0.15, f"not a blend: {c}"
    cfg_pt = dc.replace(cfg, tex_filter="point")
    img_pt = np.asarray(Renderer(cfg_pt).render(quad_flat,
                                                jax.random.PRNGKey(0)))
    # a pixel strictly inside the top-left quadrant: point fetch is the
    # saturated red texel there, bilinear has begun blending toward it
    c_pt = img_pt[13, 13]
    assert c_pt[0] > 2 * max(c_pt[1], c_pt[2]), \
        f"point fetch should saturate red: {c_pt}"


def test_lod_minification_picks_coarse_level(tmp_path):
    """A 64x64 texture rendered at 8x8 is heavily minified: the LOD
    heuristic must fetch from a coarse level. The texture is crafted so
    every coarse-level texel (the [::4, ::4] decimation survivors) is
    pure red while everything else is blue -- a level-0/1 fetch would
    show blue, level >= 2 is all red."""
    rng = np.random.default_rng(0)
    tex = np.zeros((64, 64, 3), np.float32)
    tex[..., 2] = 1.0                                      # blue
    tex[::4, ::4] = [1.0, 0.0, 0.0]                        # red survivors
    global CHECKER
    saved = CHECKER
    try:
        CHECKER = tex
        path = _textured_quad_gltf(tmp_path)
    finally:
        CHECKER = saved
    from tinypathtracer_tpu import load_scene

    flat = load_scene(path).flatten(
        env_radiance=np.ones((4, 8, 3), np.float32))
    cfg = RenderConfig(width=8, height=8, spp=32, max_depth=2,
                       intersector="dense", tex_filter="bilinear")
    img = np.asarray(Renderer(cfg).render(flat, jax.random.PRNGKey(1)))
    center = img[3:5, 3:5].reshape(-1, 3).mean(axis=0)
    assert center[0] > 4 * center[2], \
        f"expected coarse (red) level, got {center}"


def test_texel_gradients_bilinear_fd(quad_flat):
    from tinypathtracer_tpu.diff.invrender import Params, mse_loss

    cfg = RenderConfig(width=12, height=12, spp=4, max_depth=2,
                       intersector="dense", tile_pixels=144,
                       tex_filter="bilinear")
    key = jax.random.PRNGKey(5)
    target = jnp.zeros((12, 12, 3), jnp.float32)
    params = Params.from_scene(quad_flat)

    loss = lambda p: mse_loss(p, quad_flat, cfg, target, key)
    g = np.asarray(jax.grad(loss)(params).tex_atlas)
    assert np.isfinite(g).all() and np.abs(g).max() > 0

    eps = 2e-3
    for (t, y, x, c) in [(0, 0, 0, 0), (0, 1, 1, 2)]:
        atlas_p = params.tex_atlas.at[t, y, x, c].add(eps)
        atlas_m = params.tex_atlas.at[t, y, x, c].add(-eps)
        lp = loss(Params(**{**params.__dict__, "tex_atlas": atlas_p}))
        lm = loss(Params(**{**params.__dict__, "tex_atlas": atlas_m}))
        fd = (float(lp) - float(lm)) / (2 * eps)
        np.testing.assert_allclose(g[t, y, x, c], fd, rtol=5e-2, atol=1e-5)
