"""Large-scene (stress) coverage: the scalable intersector story.

These tests build a ~14k-face procedural sphere room
(models/procedural.py) and check that the dense intersector stays
oracle-exact at that scale (a ray subsample vs chunked brute force), and
that a small render completes and looks sane. bench.py's
BENCH_SCENE=stress runs a ~61k-face room at full size.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu import RenderConfig, Renderer
from tinypathtracer_tpu.models.procedural import sphere_grid_scene
from tinypathtracer_tpu.ops import intersect
from tinypathtracer_tpu.ops.dense import (FACE_QUANTUM, XLA_TILE,
                                          closest_hit_dense,
                                          precompute_woop)
from tinypathtracer_tpu.render.integrator import TraceData


@pytest.fixture(scope="module")
def stress():
    flat = sphere_grid_scene(grid=3, n_lat=12, n_lon=24)   # ~14k faces
    data = jax.jit(TraceData.from_scene)(flat)
    return flat, data


def test_scene_size(stress):
    flat, data = stress
    f = flat.indices.shape[0]
    assert f > XLA_TILE, f      # spans several reduction tiles
    woop = jax.jit(precompute_woop)(data.tri_verts)
    assert woop.n_padded >= f and woop.n_padded % FACE_QUANTUM == 0


def test_gated_dense_matches_bruteforce_subsample(stress):
    flat, data = stress
    woop = jax.jit(precompute_woop)(data.tri_verts)
    rng = np.random.default_rng(3)
    n = 256
    o = jnp.asarray(rng.uniform(-4.5, 4.5, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    fd, td, _ = closest_hit_dense(o, d, woop)
    fb, tb, _ = intersect.closest_hit_bruteforce(o, d, data.tri_verts,
                                                 chunk=512)
    fd, fb = np.asarray(fd), np.asarray(fb)
    agree = (fd == fb).mean()
    assert agree > 0.99, f"hit agreement {agree}"
    both = (fd == fb) & (fd >= 0)
    assert both.sum() > 200      # inside a closed room: almost all hit
    np.testing.assert_allclose(np.asarray(td)[both], np.asarray(tb)[both],
                               rtol=1e-3, atol=1e-4)


def test_stress_render_smoke(stress):
    flat, _ = stress
    cfg = RenderConfig(width=24, height=24, spp=2, max_depth=3,
                       intersector="dense", rays_per_dispatch=24 * 24 * 2)
    img = np.asarray(Renderer(cfg).render(flat, jax.random.PRNGKey(0)))
    assert np.isfinite(img).all()
    assert img.mean() > 1e-3     # the emissive panel lights the room


def test_resolve_intersector_routes_by_face_count():
    from tinypathtracer_tpu.render.renderer import (DENSE_MAX_FACES,
                                                    resolve_intersector)

    cfg = RenderConfig()
    assert resolve_intersector(cfg, DENSE_MAX_FACES) == "dense"
    assert resolve_intersector(cfg, DENSE_MAX_FACES + 1) == "bvh"
    for isect in ("bvh", "bruteforce"):
        cfg = RenderConfig(intersector=isect)
        assert resolve_intersector(cfg, 10 * DENSE_MAX_FACES) == isect


def test_large_scene_oracle():
    """Above the crossover: the intersector a "dense" request resolves
    to (the LBVH walk) against the plain dense version, on a scene of
    ~61k faces (subsampled rays)."""
    from tinypathtracer_tpu.ops.lbvh import build_lbvh
    from tinypathtracer_tpu.ops.traverse import closest_hit_bvh
    from tinypathtracer_tpu.render.renderer import resolve_intersector

    flat = sphere_grid_scene(grid=4, n_lat=16, n_lon=32)
    data = jax.jit(TraceData.from_scene)(flat)
    f = data.tri_verts.shape[0]
    assert resolve_intersector(RenderConfig(), f) == "bvh"
    bvh = jax.jit(build_lbvh)(data.tri_verts)
    woop = jax.jit(precompute_woop)(data.tri_verts)
    rng = np.random.default_rng(20)
    o = jnp.asarray(rng.uniform(-4.5, 4.5, (128, 3)).astype(np.float32))
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    fb, tb, _ = closest_hit_bvh(o, d, bvh)
    fd, td, _ = closest_hit_dense(o, d, woop)
    fb, fd = np.asarray(fb), np.asarray(fd)
    assert (fb >= 0).mean() > 0.8            # the room is open at -z
    assert (fb == fd).mean() > 0.99           # Woop vs MT rounding at edges
    both = (fb == fd) & (fb >= 0)
    np.testing.assert_allclose(np.asarray(tb)[both], np.asarray(td)[both],
                               rtol=1e-3, atol=1e-4)
