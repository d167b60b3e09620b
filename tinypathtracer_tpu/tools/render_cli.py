"""Command-line renderer.

The reference has no CLI at all: scene and env-map paths are hardcoded
in main.cu:11-12 and every knob is a compile-time constant (SURVEY.md
par. 5 "Config / flag system: none"). This CLI is that missing config
system: scene, resolution, spp, depth, estimator mode, intersector and
sharding are all runtime flags.

    python -m tinypathtracer_tpu.tools.render_cli \
        --scene scene.gltf --out scene.png \
        --width 512 --height 512 --spp 32
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tinypathtracer-tpu",
                                description="differentiable path tracer")
    p.add_argument("--scene", required=True, help=".gltf scene file")
    p.add_argument("--out", default="out.png", help="output PNG path")
    p.add_argument("--env", default=None,
                   help="equirect env map (image or .npy); default: procedural sky")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--mode", choices=["reference", "physical"], default="reference")
    # default matches config.RenderConfig: "dense" (resolves to "bvh"
    # for large scenes, renderer.resolve_intersector); "bruteforce" is
    # the Moller-Trumbore oracle.
    p.add_argument("--intersector",
                   choices=["dense", "bvh", "bruteforce"],
                   default="dense")
    p.add_argument("--bvh-source", choices=["device", "host"],
                   default="device",
                   help="where the LBVH is built (intersector=bvh): "
                        "'device' rebuilds inside the jitted frame, "
                        "'host' builds once per scene on CPU")
    p.add_argument("--aov", choices=["normal", "depth", "hitmask"],
                   default=None,
                   help="render a debug AOV instead of the beauty pass "
                        "(reference RENDER_NORMAL path_tracer.cu:322-342 "
                        "/ hit-mask debug_utils.h:130-169)")
    p.add_argument("--tile-pixels", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shard", action="store_true",
                   help="shard pixels across all local devices")
    p.add_argument("--stats", action="store_true", help="print timing JSON to stderr")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import jax

    from tinypathtracer_tpu import load_scene, RenderConfig
    from tinypathtracer_tpu.models.envlight import gradient_sky, load_env_image
    from tinypathtracer_tpu.render import film

    env = load_env_image(args.env) if args.env else gradient_sky(64, 128)
    scene = load_scene(args.scene)
    flat = scene.flatten(env_radiance=env)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, mode=args.mode,
                       intersector=args.intersector,
                       bvh_source=args.bvh_source,
                       tile_pixels=min(args.tile_pixels, args.width * args.height))
    key = jax.random.PRNGKey(args.seed)

    t0 = time.perf_counter()
    if args.aov:
        from tinypathtracer_tpu.render.aov import render_aov_jit

        img = np.asarray(render_aov_jit(flat, cfg, key, args.aov))
        dt = time.perf_counter() - t0
        film.write_png(args.out, img)
        if args.stats:
            print(json.dumps({"seconds": round(dt, 3), "aov": args.aov,
                              "mean": float(img.mean())}), file=sys.stderr)
        print(args.out)
        return
    if args.shard:
        from tinypathtracer_tpu.parallel.mesh import make_mesh
        from tinypathtracer_tpu.parallel.shard import make_sharded_renderer

        mesh = make_mesh()
        img = make_sharded_renderer(cfg, mesh)(flat, key)
    else:
        from tinypathtracer_tpu import Renderer

        img = Renderer(cfg).render(flat, key)
    img = np.asarray(img)
    dt = time.perf_counter() - t0

    film.write_png(args.out, img)
    if args.stats:
        rays = args.width * args.height * args.spp
        print(json.dumps({"seconds": round(dt, 3),
                          "primary_rays": rays,
                          "rays_per_s": round(rays / dt, 1),
                          "mean_radiance": float(img.mean())}), file=sys.stderr)
    print(args.out)


if __name__ == "__main__":
    main()
