"""tinypathtracer_tpu: a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
Cyruscxy/TinyPathTracer (CUDA/Vulkan): glTF scene
loading, LBVH acceleration structures, multi-bounce Monte-Carlo shading
with delta + HDR environment lights, and textured materials -- built as
batched, jit-compiled array programs instead of divergent per-thread
megakernels, sharded over device meshes instead of CUDA grids, and
end-to-end differentiable.

Public API:
    load_scene(path)            -> Scene (host-side, numpy)
    Scene.flatten()             -> FlatScene (SoA device arrays)
    RenderConfig(...)           -> resolution / spp / depth / mode config
    render(scene, cfg, key)     -> radiance image [H, W, 3]
    Renderer(...)               -> jitted, reusable render pipeline
"""

from tinypathtracer_tpu.config import RenderConfig
from tinypathtracer_tpu.models.scene import Scene, FlatScene, load_scene
from tinypathtracer_tpu.models.camera import Camera
from tinypathtracer_tpu.render.renderer import Renderer, render

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "FlatScene",
    "load_scene",
    "Camera",
    "Renderer",
    "render",
    "__version__",
]
