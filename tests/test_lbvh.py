"""LBVH structural invariants + traversal equivalence vs brute force.

The reference's dev-time BVH checkers (debug_utils.h:51-128: every node
referenced by exactly one parent, internal nodes reference two children)
become pytest properties here, plus the all-triangles oracle test the
reference never had (SURVEY.md par. 4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu.ops import intersect
from tinypathtracer_tpu.ops.lbvh import build_lbvh
from tinypathtracer_tpu.ops.traverse import closest_hit_bvh


def random_tris(n, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n, 1, 3))
    tris = centers + rng.normal(scale=0.3, size=(n, 3, 3))
    return jnp.asarray(tris.astype(np.float32))


def random_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 500])
def test_structure_invariants(n):
    bvh = build_lbvh(random_tris(n))
    if n == 1:
        assert int(bvh.parent[0]) == -1
        return
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    parent = np.asarray(bvh.parent)
    n_nodes = 2 * n - 1
    # every node except root 0 is referenced exactly once as a child
    refs = np.zeros(n_nodes, dtype=int)
    np.add.at(refs, left, 1)
    np.add.at(refs, right, 1)
    assert refs[0] == 0
    assert (refs[1:] == 1).all()
    # parent pointers agree with child links
    for k in range(n - 1):
        assert parent[left[k]] == k
        assert parent[right[k]] == k
    assert parent[0] == -1
    # leaf fids are a permutation of faces
    assert sorted(np.asarray(bvh.leaf_fid).tolist()) == list(range(n))


@pytest.mark.parametrize("n", [2, 64, 500])
def test_box_containment(n):
    bvh = build_lbvh(random_tris(n, seed=3))
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    assert (bmin <= bmax).all()
    for k in range(n - 1):
        for c in (left[k], right[k]):
            assert (bmin[k] <= bmin[c] + 1e-6).all()
            assert (bmax[k] >= bmax[c] - 1e-6).all()
    # root box encloses all leaf boxes
    assert (bmin[0] <= bmin.min(axis=0) + 1e-6).all()
    assert (bmax[0] >= bmax.max(axis=0) - 1e-6).all()


def test_duplicate_centroids():
    # identical triangles => identical morton codes; the index tiebreak
    # must still build a valid tree (the reference could degenerate here)
    tri = np.broadcast_to(
        np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), (33, 3, 3))
    bvh = build_lbvh(jnp.asarray(tri))
    refs = np.zeros(2 * 33 - 1, dtype=int)
    np.add.at(refs, np.asarray(bvh.left), 1)
    np.add.at(refs, np.asarray(bvh.right), 1)
    assert (refs[1:] == 1).all()


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (17, 2), (200, 3), (1000, 4)])
def test_traversal_matches_bruteforce(n, seed):
    tris = random_tris(n, seed=seed)
    o, d = random_rays(256, seed=seed + 10)
    bvh = build_lbvh(tris)
    f_bvh, t_bvh, uv_bvh = closest_hit_bvh(o, d, bvh)
    f_bf, t_bf, uv_bf = intersect.closest_hit_bruteforce(o, d, tris)
    f_bvh, f_bf = np.asarray(f_bvh), np.asarray(f_bf)
    t_bvh, t_bf = np.asarray(t_bvh), np.asarray(t_bf)
    hit = f_bf >= 0
    # same hit/miss classification and same winning triangle distance
    np.testing.assert_array_equal(f_bvh >= 0, hit)
    np.testing.assert_allclose(t_bvh[hit], t_bf[hit], rtol=1e-5)
    # same face except measure-zero t-ties
    diff = (f_bvh != f_bf) & hit
    assert diff.mean() < 0.01
    np.testing.assert_allclose(np.asarray(uv_bvh)[~diff & hit],
                               np.asarray(uv_bf)[~diff & hit], atol=1e-4)


def test_traversal_on_box_scene(make_room):
    flat = make_room()
    wv, _ = flat.world_geometry()
    tris = wv[flat.indices]
    bvh = build_lbvh(tris)
    # rays from inside the closed room: every direction hits something
    o, d = random_rays(512, seed=7)
    o = jnp.asarray(np.array([[0.0, 1.0, 0.0]], np.float32)) + 0.0 * o
    f_bvh, t_bvh, _ = closest_hit_bvh(o, d, bvh)
    f_bf, t_bf, _ = intersect.closest_hit_bruteforce(o, d, tris)
    hit = np.asarray(f_bf) >= 0
    assert hit.mean() > 0.3  # plenty of hits from inside-ish the scene
    np.testing.assert_array_equal(np.asarray(f_bvh) >= 0, hit)
    np.testing.assert_allclose(np.asarray(t_bvh)[hit], np.asarray(t_bf)[hit],
                               rtol=1e-5)


def test_jit_build_and_traverse():
    tris = random_tris(128)
    o, d = random_rays(64)

    @jax.jit
    def go(tris, o, d):
        bvh = build_lbvh(tris)
        return closest_hit_bvh(o, d, bvh)

    fid, t, uv = go(tris, o, d)
    f_bf, t_bf, _ = intersect.closest_hit_bruteforce(o, d, tris)
    np.testing.assert_array_equal(np.asarray(fid) >= 0, np.asarray(f_bf) >= 0)


def test_host_bvh_source_matches_device(make_room):
    from tinypathtracer_tpu import RenderConfig, Renderer

    flat = make_room()
    kw = dict(width=24, height=24, spp=2, max_depth=2,
              intersector="bvh", tile_pixels=24 * 24)
    key = jax.random.PRNGKey(0)
    dev = np.asarray(Renderer(RenderConfig(bvh_source="device", **kw)).render(flat, key))
    host = np.asarray(Renderer(RenderConfig(bvh_source="host", **kw)).render(flat, key))
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=1e-7)
