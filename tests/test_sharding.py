"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY.md par. 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu import RenderConfig
from tinypathtracer_tpu.parallel import mesh as mesh_mod
from tinypathtracer_tpu.parallel.shard import render_frame_sharded
from tinypathtracer_tpu.render.renderer import render_frame


@pytest.fixture(scope="module")
def flat(make_room):
    return make_room()


def test_device_count():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    m = mesh_mod.make_mesh()
    assert m.shape == {"data": 8, "sample": 1}
    m2 = mesh_mod.make_mesh(n_data=4, n_sample=2)
    assert m2.shape == {"data": 4, "sample": 2}
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(n_data=8, n_sample=2)


@pytest.mark.parametrize("n_data,n_sample", [(8, 1), (4, 2), (2, 2)])
def test_sharded_render_matches_shape_and_finite(flat, n_data, n_sample):
    cfg = RenderConfig(width=24, height=16, spp=4, max_depth=2,
                       intersector="bvh", tile_pixels=64)
    m = mesh_mod.make_mesh(n_data=n_data, n_sample=n_sample)
    img = np.asarray(render_frame_sharded(flat, cfg, jax.random.PRNGKey(0), m))
    assert img.shape == (16, 24, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


def test_data_sharding_matches_single_device(flat):
    """Pure pixel DP must be bit-identical to single-device rendering:
    the per-tile key derivation depends only on global pixel ids."""
    cfg = RenderConfig(width=32, height=16, spp=2, max_depth=2,
                       intersector="bvh", tile_pixels=64)
    single = np.asarray(render_frame(flat, cfg, jax.random.PRNGKey(1)))
    m = mesh_mod.make_mesh(n_data=8, n_sample=1)
    sharded = np.asarray(render_frame_sharded(flat, cfg, jax.random.PRNGKey(1), m))
    np.testing.assert_array_equal(single, sharded)


def test_sharded_train_step_runs_and_descends(flat):
    import optax
    from tinypathtracer_tpu.diff.invrender import Params, make_sharded_train_step

    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2,
                       intersector="bvh", tile_pixels=64)
    m = mesh_mod.make_mesh(n_data=4, n_sample=2)
    key = jax.random.PRNGKey(2)

    # target from the SAME sharded estimator so the loss at the true
    # parameters is exactly zero (no irreducible key-mismatch floor)
    true_params = Params.from_scene(flat)
    target = render_frame_sharded(flat, cfg, key, m).reshape(16, 16, 3) / cfg.spp

    import dataclasses
    params = dataclasses.replace(
        true_params,
        mtl_base_color=true_params.mtl_base_color.at[0].set(
            jnp.array([0.1, 0.9, 0.1])))
    # optimize only the perturbed group (masked optimizer composes with
    # the sharded step; full-pytree adam is a conditioning question,
    # not a distribution one)
    mask = Params(mtl_base_color=True, mtl_emission=False,
                  light_intensity=False, env_radiance=False,
                  cam_to_world=False, tex_atlas=False)
    from tinypathtracer_tpu.diff.invrender import project_physical
    opt = optax.masked(optax.adam(0.05), mask)
    step = make_sharded_train_step(cfg, m, opt, project_fn=project_physical)
    opt_state = opt.init(params)
    first = best = None
    for i in range(25):
        params, opt_state, loss = step(params, opt_state, flat, target, key)
        loss = float(loss)
        first = loss if first is None else first
        best = loss if best is None else min(best, loss)
    assert np.isfinite(first)
    assert best < 0.5 * first, (first, best)


def test_sharded_grads_match_single_device(flat):
    """psum-averaged sharded gradients == single-device gradients."""
    import dataclasses
    import optax
    from tinypathtracer_tpu.diff import invrender

    # tile_pixels chosen so single-device and 8-way-sharded renders tile
    # pixels identically (same per-tile key folds): 256 px / 8 = 32
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2,
                       intersector="bvh", tile_pixels=32)
    key = jax.random.PRNGKey(4)
    params = invrender.Params.from_scene(flat)
    target = jnp.zeros((16, 16, 3))

    g_single = jax.grad(invrender.mse_loss)(params, flat, cfg, target, key)

    # one SGD step with lr so that params' - params == -lr * grad
    lr = 1.0
    m = mesh_mod.make_mesh(n_data=8, n_sample=1)
    step = invrender.make_sharded_train_step(cfg, m, optax.sgd(lr))
    opt_state = optax.sgd(lr).init(params)
    params2, _, _ = step(params, opt_state, flat, target, key)
    g_sharded = jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a) - np.asarray(b)) / -lr, params2, params)

    for name in ["mtl_base_color", "mtl_emission", "env_radiance"]:
        a = np.asarray(getattr(g_single, name))
        b = np.asarray(getattr(g_sharded, name))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6, err_msg=name)
