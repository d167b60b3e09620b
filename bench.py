"""Benchmark harness: primary rays/s on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}

vs_baseline is measured against the BASELINE.json north-star target of
1e8 primary rays/s per device (the reference publishes no numbers of its
own), so 1.0 == target reached. Refuses to run without a GPU.

Env overrides (all optional):
  BENCH_WIDTH/HEIGHT/SPP/DEPTH  workload shape (default 512x512@16, d8)
  BENCH_INTERSECTOR             "dense" (default; resolves to the LBVH walk
                                above renderer.DENSE_MAX_FACES) | "bvh" |
                                "bruteforce"
  BENCH_REPEATS                 timed repetitions (default 3, best-of)
  BENCH_MODE                    "fwdbwd" (default) | "fwd": fwdbwd times
                                one train step of the MSE loss
                                (diff/invrender.make_train_step)
  BENCH_SCENE                   "textured" (default) | "stress", both from
                                models/procedural: textured is a
                                1,804-face room with checker-textured
                                diffuse materials; stress is the
                                61,452-face sphere grid
"""

from __future__ import annotations

import json
import os
import sys
import time


def main():
    import numpy as np
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(f"bench.py needs a GPU; JAX backend is "
                           f"{jax.default_backend()!r}")
    from tinypathtracer_tpu.utils.jaxcache import use_compile_cache

    use_compile_cache()

    from tinypathtracer_tpu import RenderConfig, Renderer
    from tinypathtracer_tpu.models.envlight import gradient_sky
    from tinypathtracer_tpu.models.procedural import sphere_grid_scene

    width = int(os.environ.get("BENCH_WIDTH", 512))
    height = int(os.environ.get("BENCH_HEIGHT", 512))
    spp = int(os.environ.get("BENCH_SPP", 16))
    depth = int(os.environ.get("BENCH_DEPTH", 8))
    intersector = os.environ.get("BENCH_INTERSECTOR", "dense")
    repeats = int(os.environ.get("BENCH_REPEATS", 3))
    mode = os.environ.get("BENCH_MODE", "fwdbwd")
    scene_name = os.environ.get("BENCH_SCENE", "textured")

    sky = np.asarray(gradient_sky(64, 128))
    if scene_name == "stress":
        flat = sphere_grid_scene(grid=4, n_lat=16, n_lon=32,
                                 env_radiance=sky)
        scene_label = f"sphere-grid {flat.indices.shape[0]} faces"
    elif scene_name == "textured":
        # textured-workload analogue of BASELINE.json config[3]: a room
        # whose diffuse materials fetch a checker atlas with real
        # texcoords every bounce (texture.cu:129-170)
        flat = sphere_grid_scene(grid=2, n_lat=8, n_lon=16, textured=True,
                                 env_radiance=sky)
        scene_label = f"textured sphere-grid {flat.indices.shape[0]} faces"
    else:
        raise ValueError(f"unknown BENCH_SCENE {scene_name!r}")
    # fwd+bwd keeps per-chunk live state (carries per bounce) alive for
    # the backward pass; smaller chunks bound that footprint.
    default_chunk = 1 << 18 if mode == "fwdbwd" else 1 << 20
    chunk = int(os.environ.get("BENCH_CHUNK", default_chunk))
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth,
                       intersector=intersector, rays_per_dispatch=chunk)

    key = jax.random.PRNGKey(0)
    primary_rays = width * height * spp
    target = 1e8

    if mode == "fwdbwd":
        import optax
        from tinypathtracer_tpu.diff.invrender import (
            Params, make_train_step, mse_loss)

        params = Params.from_scene(flat)
        opt = optax.adam(1e-2)
        opt_state = opt.init(params)
        tgt = jax.numpy.zeros((height, width, 3), jax.numpy.float32)
        step = make_train_step(cfg, opt)

        params_w, opt_w, loss = step(params, opt_state, flat, tgt, key)
        loss0 = float(loss)            # compile + warmup, sync by readback
        assert np.isfinite(loss0), "non-finite loss"
        best = float("inf")
        for i in range(repeats):
            t0 = time.perf_counter()
            _, _, loss = step(params, opt_state, flat, tgt,
                              jax.random.PRNGKey(i + 1))
            float(loss)
            best = min(best, time.perf_counter() - t0)
        metric = (f"primary rays/s fwd+bwd ({scene_label} "
                  f"{width}x{height}@{spp}spp d{depth}, {intersector})")
    else:
        r = Renderer(cfg)
        img = np.asarray(r.render(flat, key))          # compile + warmup
        assert np.isfinite(img).all(), "non-finite radiance"
        assert img.mean() > 0.01, "suspiciously dark image"

        best = float("inf")
        for i in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(r.render(flat, jax.random.PRNGKey(i + 1)))
            best = min(best, time.perf_counter() - t0)
        metric = (f"primary rays/s ({scene_label} "
                  f"{width}x{height}@{spp}spp d{depth}, {intersector})")

    rays_per_s = primary_rays / best
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": metric,
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / target, 6),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # emit a parseable failure record, nonzero exit
        print(json.dumps({
            "metric": ("primary rays/s "
                       f"({os.environ.get('BENCH_SCENE', 'textured')} scene)"),
            "value": 0.0,
            "unit": "rays/s",
            "vs_baseline": 0.0,
            "error": f"{type(e).__name__}: {e}",
        }))
        sys.exit(1)
