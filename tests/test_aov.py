"""AOV debug renders (render/aov.py): smoke + semantics.

Mirrors the reference's RENDER_NORMAL compile path
(path_tracer.cu:322-342) and checkHitStatus hit-mask
(debug_utils.h:130-169).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinypathtracer_tpu import RenderConfig
from tinypathtracer_tpu.render.aov import AOV_KINDS, render_aov_jit


@pytest.fixture(scope="module")
def box_flat(make_room):
    return make_room()


@pytest.mark.parametrize("kind", AOV_KINDS)
def test_aov_smoke(box_flat, kind):
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=1,
                       intersector="dense")
    img = np.asarray(render_aov_jit(box_flat, cfg, jax.random.PRNGKey(0),
                                    kind))
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
    # the camera is inside the closed room: most pixels hit something
    assert (img.sum(-1) > 0).mean() > 0.3


def test_hitmask_values(box_flat):
    cfg = RenderConfig(width=24, height=24, spp=1, max_depth=1,
                       intersector="dense")
    img = np.asarray(render_aov_jit(box_flat, cfg, jax.random.PRNGKey(1),
                                    "hitmask"))
    vals = np.unique(np.round(img, 6))
    # reference writes exactly 125/255 on hit, 0 on miss
    assert set(vals).issubset({0.0, np.float32(np.round(125 / 255, 6))})


def test_normal_aov_is_abs_normal(box_flat):
    """The |normal| AOV is a unit vector wherever something was hit."""
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=1,
                       intersector="dense")
    img = np.asarray(render_aov_jit(box_flat, cfg, jax.random.PRNGKey(2),
                                    "normal"))
    hit = img.sum(-1) > 0
    assert hit.any()
    # |n| is a unit vector wherever something was hit
    norms = np.linalg.norm(img[hit], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)
