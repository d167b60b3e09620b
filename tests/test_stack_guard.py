"""Traversal stack-overflow guards (round-2 verdict weak #5).

A Karras LBVH over collinear centroids with strictly increasing morton
codes degenerates to a depth ~F comb (each split peels one leaf). The
fixed per-ray stacks used to clamp-and-overwrite silently; now the
renderer measures the built tree and refuses loudly, and a big-enough
stack still produces oracle-exact results on the same degenerate tree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu.ops import intersect
from tinypathtracer_tpu.ops.lbvh import build_lbvh, tree_depth
from tinypathtracer_tpu.ops.traverse import closest_hit_bvh


def _comb_scene(extra=0):
    """Adversarial Karras input: centroids quantizing to morton codes
    2^0, 2^1, ..., 2^29 (strictly nested prefixes), which build a
    ~30-deep comb -- each split peels exactly one leaf. Morton bit i
    comes from axis i%3, quantized bit i//3 (ops/lbvh.morton30), so
    code 2^i needs axis i%3 at grid cell 2^(i//3) and the others at 0.
    Two anchor triangles pin the scene AABB to [0, 1024]^3 so grid
    cells land exactly. `extra` appends equal-code duplicates (the
    index tiebreak then adds ~log2 more depth)."""
    pos = []
    for i in range(30):
        p = [0.0, 0.0, 0.0]
        p[i % 3] = float(2 ** (i // 3)) + 0.5
        pos.append(p)
    pos.append([0.25, 0.25, 0.25])          # anchor at the origin cell
    pos.append([1023.5, 1023.5, 1023.5])    # anchor at the far corner
    for k in range(extra):
        # same morton cell (cells are ~1 wide) -> equal codes, but
        # distinct depths so closest-hit winners stay unique
        pos.append([0.25, 0.25, 0.25 - 0.001 * (k + 1)])
    tris = np.zeros((len(pos), 3, 3), np.float32)
    for i, p in enumerate(pos):
        tris[i] = [[p[0] - 0.2, p[1] - 0.2, p[2]],
                   [p[0] + 0.2, p[1] - 0.2, p[2]],
                   [p[0], p[1] + 0.2, p[2]]]
    return jnp.asarray(tris)


def test_comb_tree_is_deep():
    tris = _comb_scene()
    bvh = build_lbvh(tris)
    depth = int(tree_depth(bvh))
    assert depth > 20, f"expected a degenerate comb, got depth {depth}"


def test_renderer_refuses_overflowing_stack(make_room):
    from tinypathtracer_tpu import RenderConfig, Renderer

    # graft the comb geometry into a renderable scene, overwriting its
    # vertices/indices
    flat = make_room(grid=0, env=(4, 8))
    tris = np.asarray(_comb_scene())
    import dataclasses
    f = tris.shape[0]
    flat = dataclasses.replace(
        flat,
        vertices=jnp.asarray(tris.reshape(-1, 3)),
        normals=jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (3 * f, 1)),
        texcoords=jnp.zeros((3 * f, 2), jnp.float32),
        indices=jnp.arange(3 * f, dtype=jnp.int32).reshape(f, 3),
        face_mtl=jnp.zeros((f,), jnp.int32),
        vert_obj=jnp.zeros((3 * f,), jnp.int32),
        vert_mats=jnp.eye(4)[None],
        normal_mats=jnp.eye(4)[None],
        obj_face_begin=jnp.zeros((1,), jnp.int32),
        obj_mtl_idx=jnp.zeros((1,), jnp.int32),
    )
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1,
                       intersector="bvh", stack_depth=16)
    with pytest.raises(ValueError, match="stack_depth.*overflow"):
        Renderer(cfg).render(flat, jax.random.PRNGKey(0))


def test_deep_stack_matches_bruteforce_on_comb():
    tris = _comb_scene(extra=30)
    bvh = build_lbvh(tris)
    rng = np.random.default_rng(2)
    o = np.stack([rng.uniform(-1, 1025, 128), rng.uniform(-1, 1025, 128),
                  np.full(128, 1500.0)], -1).astype(np.float32)
    d = rng.normal(scale=0.05, size=(128, 3)).astype(np.float32)
    d[:, 2] = -1.0                            # point down at the slabs
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    fb, tb, _ = intersect.closest_hit_bruteforce(o, d, tris)
    fv, tv, _ = closest_hit_bvh(o, d, bvh, stack_depth=64)
    np.testing.assert_array_equal(np.asarray(fb), np.asarray(fv))
    hit = np.asarray(fb) >= 0
    np.testing.assert_allclose(np.asarray(tv)[hit], np.asarray(tb)[hit],
                               rtol=1e-5)


