"""Physical-mode estimator tests: energy sanity + env NEE consistency."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu import RenderConfig, Renderer
from tinypathtracer_tpu.models.envlight import (
    build_env_tables, env_lookup, gradient_sky, sample_env)


@pytest.fixture(scope="module")
def flat(make_room):
    return make_room(point_light=True, env=(16, 32))


def test_env_sampling_unbiased():
    """MC estimate of dome irradiance onto an up-facing surface via
    importance sampling matches the direct quadrature of the map."""
    env = jnp.asarray(gradient_sky(32, 64))
    tables = build_env_tables(env)
    key = jax.random.PRNGKey(0)
    n = 200_000
    dirs, pdf = sample_env(key, tables, n)
    vals = env_lookup(env, dirs)
    cos = jnp.maximum(dirs[:, 1], 0.0)
    est = np.asarray(jnp.mean(vals * (cos / pdf)[:, None], axis=0))

    # quadrature over the equirect grid
    h, w = 32, 64
    theta = (np.arange(h) + 0.5) * np.pi / h
    sa = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    cos_g = np.maximum(np.cos(theta), 0.0)[:, None]
    ref = (np.asarray(env) * (sa * cos_g)[:, :, None]).sum(axis=(0, 1))
    np.testing.assert_allclose(est, ref, rtol=0.05)


def test_env_sample_pdf_positive():
    env = jnp.asarray(gradient_sky(16, 32))
    tables = build_env_tables(env)
    dirs, pdf = sample_env(jax.random.PRNGKey(1), tables, 1000)
    assert (np.asarray(pdf) > 0).all()
    np.testing.assert_allclose(np.linalg.norm(np.asarray(dirs), axis=-1),
                               1.0, atol=1e-4)


def test_physical_mode_renders(flat):
    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=4,
                       mode="physical", intersector="bvh", tile_pixels=256,
                       russian_roulette=True)
    img = np.asarray(Renderer(cfg).render(flat, jax.random.PRNGKey(0)))
    assert np.isfinite(img).all()
    assert img.mean() > 0.01
    assert img.max() < 100.0


def test_physical_darker_than_reference_quirks(flat):
    """The reference estimator overcounts direct light (no cos/1-over-pi
    in NEE); the physical image of the same lit scene must not be
    brighter on average."""
    kwargs = dict(width=24, height=24, spp=8, max_depth=3,
                  intersector="bvh", tile_pixels=192)
    key = jax.random.PRNGKey(2)
    ref = np.asarray(Renderer(RenderConfig(mode="reference", **kwargs)).render(flat, key))
    phy = np.asarray(Renderer(RenderConfig(mode="physical", **kwargs)).render(flat, key))
    assert phy.mean() <= ref.mean() * 1.1


def test_physical_mode_differentiable(flat):
    import dataclasses
    from tinypathtracer_tpu.diff import invrender

    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=3,
                       mode="physical", intersector="bvh", tile_pixels=144)
    key = jax.random.PRNGKey(3)
    params = invrender.Params.from_scene(flat)

    def f(p):
        img = invrender.render_mean(invrender.apply_params(flat, p), cfg, key)
        return jnp.mean(img)

    g = jax.grad(f)(params)
    gv = float(g.light_intensity[0])
    assert np.isfinite(gv) and gv > 0

    def perturbed(delta):
        li = params.light_intensity.at[0].add(delta)
        return float(jax.jit(f)(dataclasses.replace(params, light_intensity=li)))

    eps = 0.05
    fd = (perturbed(eps) - perturbed(-eps)) / (2 * eps)
    assert abs(gv - fd) < 0.05 * max(abs(fd), abs(gv)) + 1e-4
