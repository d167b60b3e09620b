"""Dense (Woop-transform) intersector: parity with the brute-force
oracle, padding/degenerate handling, the Triton kernel in interpreter
mode vs its plain XLA twin, and the choice between them."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu.ops import dense, intersect
from tinypathtracer_tpu.ops.dense import (
    closest_hit_dense, precompute_woop, _dense_triton, _dense_xla)
from tinypathtracer_tpu.utils.math3d import REAL_MAX


def _random_scene(f=400, n=900, seed=0):
    rng = np.random.default_rng(seed)
    tris = jnp.asarray((rng.uniform(-3, 3, (f, 1, 3))
                        + rng.normal(scale=0.4, size=(f, 3, 3))).astype(np.float32))
    o = jnp.asarray(rng.uniform(-4, 4, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return tris, o, d


def _rays(o, d):
    return jnp.concatenate([o.T, d.T, jnp.zeros((2, o.shape[0]))], axis=0)


def _interpret(rays, planes, **kw):
    return _dense_triton(rays, planes, interpret=True, **kw)


def test_dense_matches_bruteforce():
    tris, o, d = _random_scene()
    fb, tb, uvb = intersect.closest_hit_bruteforce(o, d, tris)
    woop = precompute_woop(tris)
    fd, td, uvd = closest_hit_dense(o, d, woop)
    fb, fd = np.asarray(fb), np.asarray(fd)
    assert (fb == fd).mean() > 0.999          # Woop vs MT rounding at edges
    both = (fb == fd) & (fb >= 0)
    assert both.sum() > 100
    np.testing.assert_allclose(np.asarray(td)[both], np.asarray(tb)[both],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(uvd)[both], np.asarray(uvb)[both],
                               rtol=1e-2, atol=1e-3)


def _tie_scene():
    """Two copies of one triangle at slots 0 and 1 (equal t for every
    ray) plus a random field behind them."""
    tris, o, d = _random_scene(f=300, n=130, seed=21)
    tri = np.array([[[-1, -1, 4.5], [1, -1, 4.5], [0, 1, 4.5]]], np.float32)
    tris = jnp.concatenate([jnp.asarray(tri), jnp.asarray(tri), tris])
    o = o.at[:64].set(jnp.asarray([0.0, -0.2, 6.0]))
    d = d.at[:64].set(jnp.asarray([0.0, 0.0, -1.0]))
    return tris, o, d


def _degenerate_scene():
    """Zero-area faces (collinear, a point) among real ones."""
    tris, o, d = _random_scene(f=200, n=160, seed=13)
    t = np.asarray(tris).copy()
    t[::7] = [[0, 0, 0], [1, 1, 1], [2, 2, 2]]
    t[3::7] = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]
    return jnp.asarray(t), o, d


# (scene, kernel tiling): random triangles in one tile; a ray count
# that needs padding to the ray block; many triangle tiles; degenerate
# faces plus the padding columns after them; exact t ties.
CASES = {
    "random": (lambda: _random_scene(seed=3), {}),
    "ragged_rays": (lambda: _random_scene(f=97, n=77, seed=4),
                    dict(block_rays=32)),
    "many_tri_tiles": (lambda: _random_scene(f=700, n=96, seed=5),
                       dict(block_tris=16, block_rays=16)),
    "degenerate_and_padding": (_degenerate_scene, {}),
    "equal_t_ties": (_tie_scene, dict(block_tris=16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_triton_interpret_matches_xla(case):
    """The kernel, run by the Pallas interpreter, reproduces the plain
    version bit for bit: same per-pair arithmetic, same (t, slot)
    order."""
    make, tiling = CASES[case]
    tris, o, d = make()
    woop = precompute_woop(tris)
    rays = _rays(o, d)
    t_x, s_x, u_x, v_x = _dense_xla(rays, woop.planes)
    t_k, s_k, u_k, v_k = _interpret(rays, woop.planes, **tiling)
    hit = np.asarray(t_x) < REAL_MAX
    assert hit.any()
    np.testing.assert_array_equal(np.asarray(t_k), np.asarray(t_x))
    for a, b in ((s_k, s_x), (u_k, u_x), (v_k, v_x)):
        np.testing.assert_array_equal(np.asarray(a)[hit], np.asarray(b)[hit])
    if case == "equal_t_ties":
        # both copies tie on t; the lower morton slot of the two wins
        fid, _, _ = closest_hit_dense(o, d, woop)
        assert (np.asarray(fid)[:64] == 0).all()


def test_triton_pads_rays_and_checks_tiles():
    tris, o, d = _random_scene(f=50, n=5, seed=6)
    woop = precompute_woop(tris)
    assert woop.n_padded % dense.FACE_QUANTUM == 0
    out = _interpret(_rays(o, d), woop.planes, block_rays=16)
    assert all(x.shape == (5,) for x in out)
    with pytest.raises(ValueError, match="multiple of the triangle tile"):
        _interpret(_rays(o, d), woop.planes[:, :100], block_tris=64)


def test_xla_tiles_long_face_axes(monkeypatch):
    """More faces than one reduction tile: the scan over tiles keeps the
    lowest-slot winner across tile boundaries."""
    monkeypatch.setattr(dense, "XLA_TILE", 128)
    tris, o, d = _tie_scene()
    tris = jnp.concatenate([tris] * 3)           # 906 faces: 8 tiles
    woop = precompute_woop(tris)
    rays = _rays(o, d)
    tiled = _dense_xla.__wrapped__(rays, woop.planes)
    monkeypatch.setattr(dense, "XLA_TILE", 1 << 20)
    whole = _dense_xla.__wrapped__(rays, woop.planes)
    for a, b in zip(tiled, whole):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_choice_by_platform():
    """closest_hit_dense lowers to the Triton kernel for CUDA and to the
    plain version everywhere else."""
    tris, o, d = _random_scene(f=40, n=16, seed=7)
    woop = precompute_woop(tris)
    traced = jax.jit(closest_hit_dense).trace(o, d, woop)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda and "dense_closest_hit" in cuda
    assert "triton" not in cpu


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_mask_semantics(impl, monkeypatch):
    """Masked lanes report miss; live lanes match the unmasked call
    bit-for-bit (the mask is a post-filter, never a result change)."""
    if impl == "interpret":
        monkeypatch.setattr(dense, "_dense_xla",
                            functools.partial(_interpret, block_rays=16))
    tris, o, d = _random_scene(f=300, n=777, seed=5)
    woop = precompute_woop(tris)
    rng = np.random.default_rng(9)
    mask = jnp.asarray(rng.random(777) < 0.37)
    f0, t0, _ = closest_hit_dense(o, d, woop)
    fm, tm, _ = closest_hit_dense(o, d, woop, mask=mask)
    m = np.asarray(mask)
    np.testing.assert_array_equal(np.asarray(fm)[m], np.asarray(f0)[m])
    np.testing.assert_array_equal(np.asarray(tm)[m], np.asarray(t0)[m])
    assert (np.asarray(fm)[~m] == -1).all()
    for edge in (jnp.zeros(777, bool), jnp.ones(777, bool)):
        fe, _, _ = closest_hit_dense(o, d, woop, mask=edge)
        ref = np.where(np.asarray(edge), np.asarray(f0), -1)
        np.testing.assert_array_equal(np.asarray(fe), ref)


def test_degenerate_and_padding_never_hit():
    # one real triangle + degenerate (zero-area) ones; padding to tile
    tris = np.zeros((3, 3, 3), np.float32)
    tris[0] = [[-1, -1, -2], [1, -1, -2], [0, 1, -2]]
    tris[1] = [[0, 0, 0], [1, 1, 1], [2, 2, 2]]      # collinear
    tris[2] = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]      # a point
    woop = precompute_woop(jnp.asarray(tris))
    o = jnp.asarray(np.tile([[0, 0, 1]], (64, 1)).astype(np.float32))
    d = np.zeros((64, 3), np.float32)
    d[:, 2] = -1.0
    d[32:, 2] = 1.0                                   # away from the triangle
    fid, t, _uv = closest_hit_dense(o, jnp.asarray(d), woop)
    fid = np.asarray(fid)
    assert (fid[:32] == 0).all()
    assert (fid[32:] == -1).all()
    np.testing.assert_allclose(np.asarray(t)[:32], 3.0, rtol=1e-5)


def test_dense_tie_breaks_to_lowest_fid():
    # two identical triangles: brute force and dense must both pick fid 0
    tri = np.array([[[-1, -1, -2], [1, -1, -2], [0, 1, -2]]], np.float32)
    tris = jnp.asarray(np.concatenate([tri, tri], axis=0))
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.asarray(np.tile([[0, 0, -1]], (8, 1)).astype(np.float32))
    fb, _, _ = intersect.closest_hit_bruteforce(o, d, tris)
    fd, _, _ = closest_hit_dense(o, d, precompute_woop(tris))
    assert (np.asarray(fb) == 0).all()
    assert (np.asarray(fd) == 0).all()


def test_renderer_dense_matches_bruteforce_image(make_room):
    from tinypathtracer_tpu import RenderConfig, Renderer

    flat = make_room()
    key = jax.random.PRNGKey(7)
    kw = dict(width=48, height=48, spp=2, max_depth=4)
    a = np.asarray(Renderer(RenderConfig(intersector="bruteforce", **kw))
                   .render(flat, key))
    b = np.asarray(Renderer(RenderConfig(intersector="dense", **kw))
                   .render(flat, key))
    # identical hit decisions => identical RNG stream => identical image
    # up to Woop-vs-MT edge rounding on a handful of pixels
    close = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert close.mean() > 0.995, f"pixel agreement {close.mean()}"


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_card():
    """On a CUDA device: the compiled kernel agrees with the plain
    version bit for bit (chip_smoke.py runs the same check at 1M rays)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (run with JAX_PLATFORMS=cuda)")
    tris, o, d = _random_scene(f=3000, n=50_000, seed=8)
    woop = precompute_woop(tris)
    rays = _rays(o, d)
    ref = _dense_xla(rays, woop.planes)
    out = _dense_triton(rays, woop.planes)
    hit = np.asarray(ref[0]) < REAL_MAX
    assert hit.mean() > 0.2
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a)[hit], np.asarray(b)[hit])
