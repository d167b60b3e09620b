"""Physical-mode emissive-triangle NEE + MIS (render/integrator.py).

The test room's only light is its emissive ceiling panel; without
area NEE the physical estimator finds it purely by BSDF luck
(the round-3 verdict's weak spot #8). With power-weighted face sampling
+ balance-heuristic MIS the same spp budget must land materially closer
to a high-spp truth, and the estimator must stay unbiased (means agree).
"""

import dataclasses

import numpy as np
import jax

from tinypathtracer_tpu import RenderConfig, Renderer


def _render(flat, spp, area_nee, key, seed_cfg):
    cfg = dataclasses.replace(seed_cfg, spp=spp, area_nee=area_nee)
    return np.asarray(Renderer(cfg).render(flat, key))


def test_area_nee_reduces_variance_and_stays_unbiased(make_room):
    flat = make_room()
    base = RenderConfig(width=24, height=24, spp=4, max_depth=4,
                        mode="physical", intersector="dense",
                        tile_pixels=576)
    truth = _render(flat, 96, True, jax.random.PRNGKey(100), base)

    on = _render(flat, 6, True, jax.random.PRNGKey(1), base)
    off = _render(flat, 6, False, jax.random.PRNGKey(1), base)

    mse_on = float(np.mean((on - truth) ** 2))
    mse_off = float(np.mean((off - truth) ** 2))
    assert mse_on < 0.6 * mse_off, (
        f"area NEE should cut variance: on={mse_on:.4f} off={mse_off:.4f}")

    # unbiasedness: both estimators agree on the mean at high spp
    on_hi = _render(flat, 64, True, jax.random.PRNGKey(7), base)
    off_hi = _render(flat, 64, False, jax.random.PRNGKey(7), base)
    np.testing.assert_allclose(on_hi.mean(), off_hi.mean(), rtol=0.08)


def test_area_nee_emissive_tables(make_room):
    from tinypathtracer_tpu.render.integrator import TraceData

    flat = make_room()
    data = TraceData.from_scene(flat)
    em_w = np.asarray(data.face_emission) * np.asarray(data.face_area)
    assert (em_w > 0).any(), "the room must have emissive faces"
    np.testing.assert_allclose(np.asarray(data.em_cdf)[-1],
                               float(np.asarray(data.em_power)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(data.em_cdf),
                               np.cumsum(em_w), rtol=1e-5)
