"""Film: radiance accumulation -> displayable image.

Reference: `copyToFB` (path_tracer.cu:451-471) divides the accumulated
radiance by spp, clamps to [0, 255] uchar and flips vertically into the
Vulkan framebuffer. The renderer runs headless, so the film
writes PNG / returns numpy instead (the Vulkan display engine,
vkEngine.cu, is deliberately dropped -- see SURVEY.md L6).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def to_image(radiance_sum, spp: int):
    """Mean radiance [H, W, 3] -> float image, flipped to top-down rows."""
    img = radiance_sum / spp
    return img[::-1, :, :]


def tonemap_uint8(img):
    """Clamp to [0,1] and quantize like Spectrum::toUChar (material.h:74-81)."""
    return jnp.clip(img * 255.0, 0.0, 255.0).astype(jnp.uint8)


def write_png(path: str, img) -> None:
    """Write a float [H, W, 3] image (top-down) as PNG."""
    arr = np.asarray(tonemap_uint8(jnp.asarray(img)))
    from PIL import Image

    Image.fromarray(arr, mode="RGB").save(path)
