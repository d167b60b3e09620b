"""Test env: CPU backend with 8 virtual devices, and the in-repo scenes.

Multi-device sharding tests run on a virtual CPU mesh (SURVEY.md par. 4:
`xla_force_host_platform_device_count`), so no accelerator is needed.
Must run before jax is imported anywhere. Tests marked `gpu` run only
when the process is started with JAX_PLATFORMS=cuda on a card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def make_room():
    """Factory for the test scenes, all built in the repository.

    make_room(grid=2, n_lat=4, n_lon=8, textured=False, point_light=False,
    env=(8, 16)) -> FlatScene: models.procedural.sphere_grid_scene's
    closed room (diffuse walls, an emissive ceiling panel, grid^3
    spheres; grid=0 leaves only flat quads) under a gradient sky of
    env = (rows, cols). point_light=True adds one point light near the
    ceiling, for tests of delta-light NEE and light gradients. Scenes
    are cached per argument set for the session.
    """
    import jax.numpy as jnp
    from tinypathtracer_tpu.models.envlight import gradient_sky
    from tinypathtracer_tpu.models.procedural import sphere_grid_scene

    cache = {}

    def make(grid=2, n_lat=4, n_lon=8, textured=False, point_light=False,
             env=(8, 16)):
        key = (grid, n_lat, n_lon, textured, point_light, env)
        if key not in cache:
            flat = sphere_grid_scene(
                grid=grid, n_lat=n_lat, n_lon=n_lon, textured=textured,
                env_radiance=np.asarray(gradient_sky(*env)))
            if point_light:
                def f32(x):
                    return jnp.asarray(np.asarray(x, np.float32))

                flat = dataclasses.replace(
                    flat,
                    light_kind=jnp.zeros((1,), jnp.int32),   # ops.lights.POINT
                    light_color=f32([[1.0, 0.95, 0.9]]),
                    light_intensity=f32([40.0]),
                    light_pos=f32([[0.5, 4.0, -0.5]]),
                    light_dir=f32([[0.0, -1.0, 0.0]]),
                    light_cos_outer=f32([0.0]),
                    light_inv_cone=f32([1.0]))
            cache[key] = flat
        return cache[key]

    return make
