"""Smoke test of the path tracer on NVIDIA GPUs, through the public API.

    python chip_smoke.py              # one card
    python chip_smoke.py --multichip  # four cards: the sharded train step

One card runs four phases at full frame size (512x512 @ 16 spp, depth 8)
on the procedural scenes of models/procedural.py: the textured ~1.8k-face
room and the ~61k-face sphere room.

  1. device: refuse anything but a CUDA backend; print the card.
  2. intersection: the Triton dense kernel, its plain XLA twin and the
     Moller-Trumbore brute force on 1,048,576 random rays against both
     scenes, plus the LBVH walk that large scenes resolve to.
  3. forward frames through Renderer on both scenes, and a 64x64 @ 4 spp
     render compared with the same render on the host CPU.
  4. three train steps (make_train_step, adam) on the textured scene.

--multichip runs only the sharded train step on a ("data", "sample") =
(2, 2) mesh of four cards against the same step on one card, and pure
pixel-parallel (4, 1) rendering against one card.

Every phase raises on failure, so the process exits non-zero. The last
line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

WIDTH = HEIGHT = 512
SPP = 16
DEPTH = 8
N_RAYS = 1 << 20
SMALL = dict(grid=2, n_lat=8, n_lon=16, textured=True)   # 1,804 faces
LARGE = dict(grid=4, n_lat=16, n_lon=32)                 # 61,452 faces

# Tolerances, each with its reason.
# Woop (dense) vs Moller-Trumbore (brute force) round differently, so a
# ray grazing an edge may pick the neighbouring face.
FID_AGREE = 0.999
# Distances agree to float rounding of two different formulations.
T_RTOL, T_ATOL = 1e-3, 1e-4
# GPU vs host CPU render: division and transcendental functions round
# differently, so a path whose hit grazes an edge (or a texel or env
# boundary) can diverge; most pixels agree to rounding, a few are
# outliers.
CPU_CLOSE_RTOL, CPU_CLOSE_ATOL = 1e-3, 1e-3
CPU_MIN_CLOSE_SHARE = 0.99
CPU_MAX_MEAN_ABS = 5e-3
# Sharded vs one-card gradients: the psums over the mesh sum in another
# order than one card does.
GRAD_RTOL = 1e-3
GRAD_ATOL_REL = 1e-5      # times the largest |gradient| of any leaf
LOSS_RTOL = 1e-4


def log(*args):
    print(*args, flush=True)


def check(ok, msg):
    """Fail the phase (a plain assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def peak_bytes(device):
    """The process's peak device memory so far (JAX cannot reset it)."""
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def program_bytes(jitted, *args):
    """Arguments + outputs + temporaries of one compiled program, as
    XLA plans them: the phase's own footprint."""
    m = jitted.lower(*args).compile().memory_analysis()
    if m is None:
        return None
    return (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes)


def timed(fn, *args, reps=3):
    """(result, median seconds of reps runs after one warm-up run)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def scene(spec):
    from tinypathtracer_tpu.models.envlight import gradient_sky
    from tinypathtracer_tpu.models.procedural import sphere_grid_scene

    return sphere_grid_scene(env_radiance=np.asarray(gradient_sky(64, 128)),
                             **spec)


def random_rays(n, seed=0):
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    o = jax.random.uniform(k1, (n, 3), minval=-4.5, maxval=4.5)
    d = jax.random.normal(k2, (n, 3))
    return o, d / jnp.linalg.norm(d, axis=1, keepdims=True)


def check_hits(label, fid, t, fid_ref, t_ref):
    fid, t = np.asarray(fid), np.asarray(t)
    fid_ref, t_ref = np.asarray(fid_ref), np.asarray(t_ref)
    agree = float((fid == fid_ref).mean())
    both = (fid == fid_ref) & (fid_ref >= 0)
    log(f"  {label}: face ids agree on {agree:.6f} of rays "
        f"(need >= {FID_AGREE}: Woop vs Moller-Trumbore rounding at "
        f"edges); t within rtol={T_RTOL}, atol={T_ATOL} on agreeing hits")
    check(agree >= FID_AGREE, f"{label}: face-id agreement {agree}")
    np.testing.assert_allclose(t[both], t_ref[both], rtol=T_RTOL,
                               atol=T_ATOL, err_msg=label)


def phase_intersection(n_rays=N_RAYS, specs=(SMALL, LARGE)):
    import jax
    from tinypathtracer_tpu.ops import dense, intersect
    from tinypathtracer_tpu.ops.lbvh import build_lbvh
    from tinypathtracer_tpu.ops.traverse import closest_hit_bvh
    from tinypathtracer_tpu.render.integrator import TraceData
    from tinypathtracer_tpu.render.renderer import resolve_intersector
    from tinypathtracer_tpu import RenderConfig
    from tinypathtracer_tpu.utils.math3d import REAL_MAX

    o, d = random_rays(n_rays)
    rays = jax.numpy.concatenate([o.T, d.T, jax.numpy.zeros((2, n_rays))])
    kernel = jax.jit(dense._dense_triton)
    plain = jax.jit(dense._dense_xla)
    # small face chunks keep the brute force's [rays, chunk, 3] arrays
    # from dominating the process's peak memory
    brute = jax.jit(functools.partial(intersect.closest_hit_bruteforce,
                                      chunk=16))
    walk = jax.jit(closest_hit_bvh)
    for spec in specs:
        flat = scene(spec)
        tv = jax.jit(TraceData.from_scene)(flat).tri_verts
        f = tv.shape[0]
        woop = jax.jit(dense.precompute_woop)(tv)
        (t_k, s_k, _, _), ms_k = timed(kernel, rays, woop.planes)
        (t_x, s_x, _, _), ms_x = timed(plain, rays, woop.planes)
        with jax.default_matmul_precision("highest"):
            (fid_b, t_b, _), ms_b = timed(brute, o, d, tv, reps=1)
        bvh = jax.jit(build_lbvh)(tv)
        (fid_w, t_w, _), ms_w = timed(walk, o, d, bvh)
        log(f"{f} faces ({resolve_intersector(RenderConfig(), f)} "
            f"resolved), {n_rays} rays: kernel {ms_k * 1e3:.2f} ms, "
            f"_dense_xla {ms_x * 1e3:.2f} ms, LBVH walk {ms_w * 1e3:.2f} ms,"
            f" brute force {ms_b * 1e3:.2f} ms")
        t_k, t_x = np.asarray(t_k), np.asarray(t_x)
        hit = t_x < REAL_MAX
        check(np.array_equal(t_k, t_x), "kernel t differs from _dense_xla")
        check(np.array_equal(np.asarray(s_k)[hit], np.asarray(s_x)[hit]),
              "kernel face ids differ from _dense_xla")
        log("  kernel == _dense_xla bit for bit in t and face id")
        perm = np.asarray(woop.perm)
        fid_k = np.where(hit, perm[np.where(hit, np.asarray(s_k), 0)], -1)
        check_hits("kernel vs brute force", fid_k, t_k, fid_b, t_b)
        check_hits("LBVH walk vs brute force", fid_w, t_w, fid_b, t_b)
    log(f"intersection phase: peak_bytes_in_use "
        f"{peak_bytes(jax.devices()[0])}")


def check_image(label, img):
    img = np.asarray(img)
    check(img.ndim == 3 and img.shape[-1] == 3, f"{label}: {img.shape}")
    check(np.isfinite(img).all(), f"{label}: non-finite pixels")
    check(img.mean() > 0.01, f"{label}: mean {img.mean()} too dark")


def phase_frames(width=WIDTH, height=HEIGHT, spp=SPP, depth=DEPTH,
                 specs=(SMALL, LARGE), cpu_size=(64, 64, 4)):
    import jax
    from tinypathtracer_tpu import RenderConfig, Renderer
    from tinypathtracer_tpu.render.renderer import (render_frame,
                                                    resolve_intersector)

    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth)
    dev = jax.devices()[0]
    for spec in specs:
        flat = scene(spec)
        r = Renderer(cfg)
        t0 = time.perf_counter()
        img = jax.block_until_ready(r.render(flat, jax.random.PRNGKey(0)))
        first = time.perf_counter() - t0
        check_image("frame", img)
        _, s = timed(lambda k: r.render(flat, k), jax.random.PRNGKey(1))
        f = flat.indices.shape[0]
        prog = program_bytes(jax.jit(render_frame, static_argnums=1), flat,
                             cfg, jax.random.PRNGKey(0))
        log(f"forward {width}x{height} @ {spp} spp d{depth}, {f} faces "
            f"({resolve_intersector(cfg, f)}): {s:.4f} s/frame "
            f"(first call {first:.1f} s incl. compile), mean "
            f"{float(np.asarray(img).mean()):.5f}, program bytes {prog}, "
            f"peak_bytes_in_use {peak_bytes(dev)}")

    w, h, n = cpu_size
    small_cfg = RenderConfig(width=w, height=h, spp=n, max_depth=depth)
    key = jax.random.PRNGKey(3)
    gpu_img = np.asarray(Renderer(small_cfg).render(scene(SMALL), key))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cpu_img = np.asarray(Renderer(small_cfg).render(scene(SMALL), key))
    diff = np.abs(gpu_img - cpu_img)
    close = (diff <= CPU_CLOSE_ATOL + CPU_CLOSE_RTOL * np.abs(cpu_img)).all(-1)
    log(f"{w}x{h} @ {n} spp vs host CPU: {close.mean():.5f} of pixels "
        f"within rtol={CPU_CLOSE_RTOL}, atol={CPU_CLOSE_ATOL} (need >= "
        f"{CPU_MIN_CLOSE_SHARE}), mean |diff| {diff.mean():.2e} (need <= "
        f"{CPU_MAX_MEAN_ABS}): GPU and CPU round division and "
        f"transcendentals differently, so a path grazing an edge can "
        f"diverge")
    check(close.mean() >= CPU_MIN_CLOSE_SHARE, f"close share {close.mean()}")
    check(diff.mean() <= CPU_MAX_MEAN_ABS, f"mean |diff| {diff.mean()}")


def _perturbed(params):
    import dataclasses

    import jax.numpy as jnp

    return dataclasses.replace(
        params, mtl_base_color=params.mtl_base_color.at[0].set(
            jnp.asarray([0.2, 0.9, 0.2])))


def _albedo_labels():
    """optax.multi_transform labels: adam on the albedos and texels, no
    update to the other parameters."""
    from tinypathtracer_tpu.diff.invrender import Params

    return Params(mtl_base_color="adam", mtl_emission="frozen",
                  light_intensity="frozen", env_radiance="frozen",
                  cam_to_world="frozen", tex_atlas="adam")


def _keep_grads(apply):
    """An optax transformation that keeps the gradients it was given as
    its state, and passes them on as updates (apply=True) or applies no
    update (apply=False)."""
    import jax
    import optax

    zeros = functools.partial(jax.tree_util.tree_map, jax.numpy.zeros_like)
    return optax.GradientTransformation(
        zeros, lambda g, s, p=None: (g if apply else zeros(g), g))


def phase_train(width=WIDTH, height=HEIGHT, spp=SPP, depth=DEPTH, steps=3):
    import jax
    import optax
    from tinypathtracer_tpu import RenderConfig
    from tinypathtracer_tpu.diff.invrender import (Params, make_train_step,
                                                   render_mean)

    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth)
    flat = scene(SMALL)
    key = jax.random.PRNGKey(5)
    target = jax.jit(render_mean, static_argnums=1)(flat, cfg, key)
    params = _perturbed(Params.from_scene(flat))
    # recover a perturbed wall colour from the albedos and texels; every
    # gradient is kept in the optimizer state and checked
    opt = optax.chain(_keep_grads(apply=True), optax.multi_transform(
        {"adam": optax.adam(0.01), "frozen": optax.set_to_zero()},
        _albedo_labels()))
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, flat, target, key)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        leaves = jax.tree_util.tree_leaves((params, opt_state))
        check(all(np.isfinite(np.asarray(x)).all() for x in leaves),
              f"step {i}: non-finite parameters or gradients")
    prog = program_bytes(step, params, opt_state, flat, target, key)
    log(f"train {width}x{height} @ {spp} spp d{depth}: losses {losses}, "
        f"step times {[round(t, 4) for t in times]} s (first incl. "
        f"compile), program bytes {prog}, peak_bytes_in_use "
        f"{peak_bytes(jax.devices()[0])}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"loss did not decrease: {losses}")


def phase_multichip(width=WIDTH, height=HEIGHT, spp=SPP, depth=DEPTH):
    import jax
    from tinypathtracer_tpu import RenderConfig
    from tinypathtracer_tpu.diff.invrender import (Params, make_sharded_train_step,
                                                   mse_loss, render_mean)
    from tinypathtracer_tpu.parallel.mesh import make_mesh
    from tinypathtracer_tpu.parallel.shard import render_frame_sharded
    from tinypathtracer_tpu.render.renderer import render_frame

    devs = jax.devices()[:4]
    check(len(devs) == 4, f"--multichip needs 4 devices, have {len(devs)}")
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth)
    flat = scene(SMALL)
    key = jax.random.PRNGKey(9)
    target = jax.jit(render_mean, static_argnums=1)(flat, cfg, key)
    params = _perturbed(Params.from_scene(flat))

    loss_1, grads_1 = jax.jit(jax.value_and_grad(mse_loss),
                              static_argnums=2)(params, flat, cfg, target,
                                                key)
    mesh = make_mesh(n_data=2, n_sample=2, devices=devs)
    probe = _keep_grads(apply=False)
    step = make_sharded_train_step(cfg, mesh, probe)
    t0 = time.perf_counter()
    _, grads_4, loss_4 = step(params, probe.init(params), flat, target, key)
    loss_4 = float(loss_4)
    first = time.perf_counter() - t0
    _, s = timed(lambda k: step(params, probe.init(params), flat, target,
                                k)[2], key)
    log(f"sharded train step (2, 2) mesh {width}x{height} @ {spp} spp "
        f"d{depth}: {s:.4f} s (first call {first:.1f} s incl. compile); "
        f"loss {loss_4:.8f} vs one card {float(loss_1):.8f} (rtol "
        f"{LOSS_RTOL}); gradients within rtol={GRAD_RTOL}, atol="
        f"{GRAD_ATOL_REL} x max|g|: the mesh psums sum in another order "
        f"than one card")
    np.testing.assert_allclose(loss_4, float(loss_1), rtol=LOSS_RTOL)
    names = ("mtl_base_color", "mtl_emission", "env_radiance",
             "cam_to_world", "tex_atlas")
    g4 = {k: np.asarray(getattr(grads_4, k)) for k in names}
    g1 = {k: np.asarray(getattr(grads_1, k)) for k in names}
    atol = GRAD_ATOL_REL * max(float(np.abs(g).max()) for g in g1.values())
    for k in names:
        check(np.isfinite(g4[k]).all() and np.isfinite(g1[k]).all(),
              f"non-finite gradient {k}")
        np.testing.assert_allclose(g4[k], g1[k], rtol=GRAD_RTOL, atol=atol,
                                   err_msg=k)

    dp = make_mesh(n_data=4, n_sample=1, devices=devs)
    single = np.asarray(jax.jit(render_frame, static_argnums=1)(flat, cfg, key))
    sharded = np.asarray(jax.jit(functools.partial(
        render_frame_sharded, mesh=dp), static_argnums=1)(flat, cfg, key))
    check(np.array_equal(single, sharded), f"pixel-parallel render differs: "
          f"max {np.abs(single - sharded).max()}")
    log("pure pixel-parallel (4, 1) render == one card, bit for bit")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multichip", action="store_true",
                        help="run only the four-card sharded train step")
    args = parser.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        log(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})")
        return 2
    from tinypathtracer_tpu.utils.jaxcache import use_compile_cache

    use_compile_cache()
    log(card_line())
    log(f"jax {jax.__version__} devices {jax.devices()}")
    if args.multichip:
        phase_multichip()
    else:
        phase_intersection()
        phase_frames()
        phase_train()
    dev = jax.devices()[0]
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
