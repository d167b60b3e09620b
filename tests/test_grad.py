"""Gradient checks vs finite differences (BASELINE north star: pixel
gradients allclose). The renderer is deterministic given a key, so
central differences of the SAME sampled estimator are a valid oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu import RenderConfig
from tinypathtracer_tpu.diff import invrender


@pytest.fixture(scope="module")
def setup(make_room):
    flat = make_room(point_light=True)
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="bvh", tile_pixels=256)
    key = jax.random.PRNGKey(3)
    return flat, cfg, key


def scalar_render(flat, cfg, key, params):
    img = invrender.render_mean(invrender.apply_params(flat, params), cfg, key)
    return jnp.mean(img)


def central_diff(f, x, eps):
    return (f(x + eps) - f(x - eps)) / (2 * eps)


@pytest.mark.parametrize("field,index", [
    ("mtl_base_color", (0, 0)),
    ("mtl_base_color", (2, 1)),
    ("mtl_emission", (4,)),
    ("light_intensity", (0,)),
    ("env_radiance", (2, 3, 1)),
])
def test_grad_matches_fd(setup, field, index):
    flat, cfg, key = setup
    params = invrender.Params.from_scene(flat)
    arr = getattr(params, field)
    # pick an emissive material index that actually exists
    if field == "mtl_emission":
        em = np.asarray(flat.mtl_emission)
        index = (int(np.argmax(em)),)

    f = jax.jit(lambda p: scalar_render(flat, cfg, key, p))
    g = jax.grad(lambda p: scalar_render(flat, cfg, key, p))(params)
    g_val = float(getattr(g, field)[index])

    def perturbed(delta):
        arr2 = arr.at[index].add(delta)
        import dataclasses
        return f(dataclasses.replace(params, **{field: arr2}))

    eps = 1e-2
    fd = (float(perturbed(eps)) - float(perturbed(-eps))) / (2 * eps)
    # f32 render + FD cancellation: compare loosely but meaningfully
    assert np.isfinite(g_val)
    if abs(fd) < 1e-4 and abs(g_val) < 1e-4:
        return  # both effectively zero
    assert abs(g_val - fd) < 0.05 * max(abs(fd), abs(g_val)) + 1e-3, \
        f"{field}{index}: autodiff {g_val} vs FD {fd}"


def test_grad_camera_interior_part(setup, make_room):
    """Camera gradients carry the INTERIOR (continuous) part only: hit
    ids are detached, so visibility/silhouette (boundary) terms that FD
    sees are not in the autodiff gradient -- the standard convention for
    path-replay differentiable renderers without edge sampling.

    A room of flat diffuse quads with no delta light (grid=0) has NO
    continuous camera dependence under the reference estimator
    (radiance = products of per-material constants, env point-sampled),
    so the interior camera gradient is exactly 0; the point light's
    distance attenuation depends on the hit position, so with it the
    gradient must be finite and nonzero.
    """
    _, cfg, key = setup
    flat = make_room(grid=0)
    params = invrender.Params.from_scene(flat)
    g = jax.grad(lambda p: scalar_render(flat, cfg, key, p))(params)
    cam_g = np.asarray(g.cam_to_world)
    assert np.isfinite(cam_g).all()
    assert np.allclose(cam_g[:3, 3], 0.0)

    flat_b = setup[0]
    g_b = jax.grad(lambda p: scalar_render(flat_b, cfg, key, p))(
        invrender.Params.from_scene(flat_b))
    cam_gb = np.asarray(g_b.cam_to_world)
    assert np.isfinite(cam_gb).all()
    assert np.abs(cam_gb[:3, 3]).max() > 1e-5


def test_point_light_intensity_grad(make_room):
    flat = make_room(point_light=True)
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2,
                       intersector="bvh", tile_pixels=256)
    key = jax.random.PRNGKey(5)
    params = invrender.Params.from_scene(flat)
    assert params.light_intensity.shape == (1,)

    f = jax.jit(lambda p: scalar_render(flat, cfg, key, p))
    g = jax.grad(lambda p: scalar_render(flat, cfg, key, p))(params)
    g_val = float(g.light_intensity[0])

    import dataclasses
    def perturbed(delta):
        li = params.light_intensity.at[0].add(delta)
        return f(dataclasses.replace(params, light_intensity=li))

    eps = 0.05
    fd = (float(perturbed(eps)) - float(perturbed(-eps))) / (2 * eps)
    assert g_val > 0  # more light -> brighter
    assert abs(g_val - fd) < 0.05 * max(abs(fd), abs(g_val)) + 1e-4


def test_optimization_recovers_albedo(setup):
    """Tiny inverse-rendering loop: perturb one wall color, recover it
    by gradient descent on the material-color table alone (optimizing
    every parameter group at once is a conditioning problem, not a
    correctness one)."""
    import dataclasses
    import optax
    flat, cfg, key = setup
    true_params = invrender.Params.from_scene(flat)
    target = invrender.render_mean(flat, cfg, key)
    true_bc = true_params.mtl_base_color

    @jax.jit
    def loss_fn(bc):
        p = dataclasses.replace(true_params, mtl_base_color=bc)
        img = invrender.render_mean(invrender.apply_params(flat, p), cfg, key)
        return jnp.mean(jnp.square(img - target))

    bc = true_bc.at[0].set(jnp.array([0.2, 0.9, 0.2]))
    opt = optax.adam(0.05)
    opt_state = opt.init(bc)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for i in range(40):
        loss, g = grad_fn(bc)
        updates, opt_state = opt.update(g, opt_state)
        bc = optax.apply_updates(bc, updates)
        losses.append(float(loss))
    assert losses[-1] < 0.05 * losses[0], f"loss did not drop: {losses[::8]}"
    # the perturbed row walked back toward the true color
    err0 = np.abs(np.asarray(true_bc[0]) - [0.2, 0.9, 0.2]).max()
    err1 = np.abs(np.asarray(true_bc[0] - bc[0])).max()
    assert err1 < 0.5 * err0, (err0, err1)


def test_remat_chunks_grads_exact(make_room):
    """cfg.remat_chunks recomputes each ray-dispatch chunk in the
    backward pass (memory bound for full-res frames): gradients and
    loss must equal the default saved-residual path."""
    import dataclasses

    from tinypathtracer_tpu.render.renderer import render_frame

    flat = make_room()
    # 2 chunks: rays_per_dispatch < total rays
    cfg = RenderConfig(width=8, height=8, spp=4, max_depth=3,
                       intersector="dense", rays_per_dispatch=128)
    key = jax.random.PRNGKey(2)
    tgt = jnp.zeros((8, 8, 3), jnp.float32)

    def loss(albedo, cfg_):
        f = dataclasses.replace(flat, mtl_base_color=albedo)
        img = render_frame(f, cfg_, key)
        return jnp.mean((img - tgt) ** 2)

    l_a, g_a = jax.value_and_grad(loss)(flat.mtl_base_color, cfg)
    l_b, g_b = jax.value_and_grad(loss)(
        flat.mtl_base_color, dataclasses.replace(cfg, remat_chunks=True))
    np.testing.assert_allclose(float(l_a), float(l_b), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(g_a), np.asarray(g_b),
                               rtol=1e-6, atol=1e-10)
