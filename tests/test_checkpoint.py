"""Checkpoint/resume + metrics tests."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu import RenderConfig, Renderer
from tinypathtracer_tpu.utils import checkpoint as ckpt


@pytest.fixture(scope="module")
def flat(make_room):
    return make_room()


def test_pytree_roundtrip(tmp_path, flat):
    from tinypathtracer_tpu.diff.invrender import Params

    params = Params.from_scene(flat)
    path = str(tmp_path / "p.npz")
    ckpt.save_pytree(path, params, meta={"step": 7})
    loaded, meta = ckpt.load_pytree(path, params)
    assert meta["step"] == 7
    np.testing.assert_array_equal(np.asarray(loaded.mtl_base_color),
                                  np.asarray(params.mtl_base_color))


def test_pytree_structure_mismatch(tmp_path, flat):
    path = str(tmp_path / "p.npz")
    ckpt.save_pytree(path, {"a": jnp.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.load_pytree(path, {"b": jnp.zeros(3), "c": jnp.zeros(2)})


def test_progressive_resume_is_exact(tmp_path, flat):
    """4 samples straight == 2 samples, checkpoint, restore, 2 more."""
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=2,
                       intersector="bvh", tile_pixels=256)
    r = Renderer(cfg)
    key = jax.random.PRNGKey(0)

    straight = r.progressive()
    straight.step(flat, key, 4)

    part = r.progressive()
    part.step(flat, key, 2)
    path = str(tmp_path / "prog.npz")
    part.save(path)

    resumed = r.progressive()
    resumed.load(path)
    assert resumed.samples_done == 2
    resumed.step(flat, key, 2)

    np.testing.assert_allclose(resumed.image(), straight.image(),
                               rtol=1e-6, atol=1e-7)
    # and it matches the one-shot renderer too
    oneshot = np.asarray(r.render(flat, key))[::-1]  # undo display flip
    np.testing.assert_allclose(straight.image(), oneshot, rtol=1e-5, atol=1e-6)


def test_metrics_json(flat):
    from tinypathtracer_tpu.utils.metrics import timed_render

    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2,
                       intersector="bruteforce", tile_pixels=64)
    r = Renderer(cfg)
    img, stats = timed_render(r, flat, jax.random.PRNGKey(0))
    assert stats.primary_rays == 64
    assert stats.rays_per_s > 0
    import json

    parsed = json.loads(stats.to_json())
    assert parsed["width"] == 8
