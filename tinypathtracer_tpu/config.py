"""Render configuration.

The CUDA reference compiles all of these in as constants (window size
vkEngine.h:24, spp=64 path_tracer.cu:559, depth=8 path_tracer.cu:17,
block 16x16 path_tracer.cu:15); here they are a dataclass consumed as
static jit arguments, plus a CLI in tools/render_cli.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of one render pipeline instance.

    Everything in here is a *static* (trace-time) constant: changing any
    field recompiles the jitted pipeline.
    """

    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 8
    # "reference" reproduces the CUDA estimator exactly, including its
    # quirks (no-cosine delta-light NEE, scalar emission, extra
    # direct-bounce emitter sample; see render/integrator.py).
    # "physical" is the physically-correct estimator.
    mode: str = "reference"
    # Intersection backend: "dense" (default) tests every ray against
    # every triangle with hoisted Woop transforms -- a Triton kernel on
    # the GPU (ops/dense.py); "bvh" is the binary LBVH stack walk
    # (ops/traverse.py); "bruteforce" is the plain Moller-Trumbore
    # oracle. renderer.resolve_intersector routes "dense" requests.
    intersector: str = "dense"
    # (pixel, sample) lanes are flattened and processed in dispatch
    # chunks of up to this many rays: large chunks amortize per-bounce
    # glue and give the intersection kernel its biggest batch; the cap
    # bounds live ray-state memory (~100 B/ray). The analogue of the
    # reference's 16x16 CUDA blocks, sized for device memory.
    rays_per_dispatch: int = 1 << 20
    # Pixel tile of the sharded paths: each data shard renders a whole
    # number of tiles (parallel/shard.py). Single-device chunking is
    # controlled by rays_per_dispatch.
    tile_pixels: int = 16384
    # Fixed traversal stack depth per ray (reference uses 64,
    # path_tracer.cu:64); LBVH depth for sorted morton codes is ~2*log2(n).
    stack_depth: int = 32
    # Where the LBVH is built: "device" builds inside the jitted frame
    # (the reference's rebuild-every-frame model, path_tracer.cu:540);
    # "host" builds once per scene on CPU (csrc native builder) and
    # ships the node arrays -- the right call for static scenes.
    bvh_source: str = "device"
    # Environment light intensity scale applied on miss.
    env_scale: float = 1.0
    # Russian roulette is NOT part of the reference estimator; keep off
    # for parity. (Hook for the physical mode.)
    russian_roulette: bool = False
    # Physical mode only: emissive-triangle next-event estimation with
    # MIS against BSDF sampling (power-weighted face sampling). The
    # reference estimator's quirk analogue is its extra BSDF-sampled
    # direct ray (path_tracer.cu:387-401); this is the correct version.
    # Off = pure BSDF sampling finds emitters by luck.
    area_nee: bool = True
    # Base-color texture filtering: "point" reproduces the reference's
    # cudaFilterModePoint level-0 fetch (texture.cu:129-170, the parity
    # default); "bilinear" enables distance/ray-spread mip LOD selection
    # + bilinear filtering through the atlas mip chain -- the filtering
    # the reference's mip build (texture.cu:90-154) was for but never
    # configured. Texel gradients flow through either path.
    tex_filter: str = "point"
    # Rematerialize each ray-dispatch chunk in the backward pass.
    # Reverse-mode through the chunk map saves every chunk's per-bounce
    # carries; with remat only chunk inputs persist and the backward
    # recomputes each chunk's forward. Flip on for frames whose saved
    # carries exceed device memory.
    remat_chunks: bool = False

    def __post_init__(self):
        if self.mode not in ("reference", "physical"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.intersector not in ("dense", "bruteforce", "bvh"):
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.bvh_source not in ("device", "host"):
            raise ValueError(f"unknown bvh_source {self.bvh_source!r}")
        if self.tex_filter not in ("point", "bilinear"):
            raise ValueError(f"unknown tex_filter {self.tex_filter!r}")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height
