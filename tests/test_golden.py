"""Golden-image regression tests.

Renders every bundled reference scene at a fixed key/config and compares
against committed goldens (tests/goldens/*.npz). Any estimator or
traversal change that alters images shows up here first -- the safety
net for performance work. Regenerate deliberately with:

    python tests/test_golden.py regen
"""

import os

import numpy as np
import jax
import pytest

from tinypathtracer_tpu import load_scene, RenderConfig, Renderer
from tinypathtracer_tpu.models.envlight import gradient_sky

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SCENES = ["box", "box1", "box2", "ball", "square", "tir", "light"]


# The reference's glTF scenes; not in the repository yet (ROADMAP R1).
SCENE_DIR = os.path.join(os.path.dirname(__file__), "scenes")


def _render(name):
    scene = load_scene(os.path.join(SCENE_DIR, f"{name}.gltf"))
    flat = scene.flatten(env_radiance=gradient_sky(16, 32))
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=4,
                       intersector="bvh", tile_pixels=64 * 64)
    return np.asarray(Renderer(cfg).render(flat, jax.random.PRNGKey(42)))


@pytest.mark.parametrize("name", SCENES)
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden missing for {name} (run: python {__file__} regen)")
    img = _render(name)
    gold = np.load(path)["img"]
    assert np.isfinite(img).all()
    # bit-exactness is intended on one platform; allow float slack so
    # compiler upgrades don't spuriously fail
    np.testing.assert_allclose(img, gold, rtol=1e-4, atol=1e-5)


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for name in SCENES:
            img = _render(name)
            np.savez_compressed(os.path.join(GOLDEN_DIR, f"{name}.npz"),
                                img=img.astype(np.float32))
            print(f"wrote {name}: mean={img.mean():.4f}")
