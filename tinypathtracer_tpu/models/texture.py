"""Textures: mip pyramids + point/bilinear sampling.

Reference: texture.cu / picture.h -- FreeImage decode into a
`cudaMipmappedArray` with a point-sampled 2x downsample kernel per
level (texture.cu:15-31, 90-154) and a `cudaTextureObject_t` configured
for point filtering (texture.cu:129-170). This redesign keeps the
mip chain as a tuple of [H_l, W_l, 3] arrays (static shapes, one gather
per lookup) and implements both point and bilinear filters as batched
gathers; there is no opaque texture object -- a texture IS its arrays,
so texels are differentiable parameters like everything else.

The reference never wires per-material textures into shading (TODOs at
mesh.cuh:114, mesh.cu:155); its Texture class only ever backs the env
map. Here the same sampler serves the env light and any per-material
base-color texture a scene provides.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp


def load_image(path: str) -> np.ndarray:
    """Decode an image file to [H, W, 3] float32 in [0, 1] (PIL; the
    FreeImage role, picture.h:14-53)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def build_mip_pyramid(img, max_levels: int = 16) -> Tuple[jnp.ndarray, ...]:
    """Mip chain by 2x point decimation (texture.cu:15-31 semantics:
    each level samples the upper-left of each 2x2 block -- point, not
    box, filtering; kept for parity)."""
    levels = [jnp.asarray(img, dtype=jnp.float32)]
    while len(levels) < max_levels:
        prev = levels[-1]
        h, w = prev.shape[0], prev.shape[1]
        if h <= 1 and w <= 1:
            break
        levels.append(prev[:: 2, :: 2, :])
    return tuple(levels)


def sample_point(level, uv):
    """Nearest-texel fetch. level: [H, W, 3]; uv: [N, 2] in [0, 1]
    (wrapping). Matches cudaFilterModePoint + wrap addressing."""
    h, w = level.shape[0], level.shape[1]
    u = jnp.mod(uv[:, 0], 1.0)
    v = jnp.mod(uv[:, 1], 1.0)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return level[y, x]


def sample_bilinear(level, uv):
    """Bilinear fetch with wrap addressing (the filter the reference's
    texture object is capable of but not configured for)."""
    h, w = level.shape[0], level.shape[1]
    u = jnp.mod(uv[:, 0], 1.0) * w - 0.5
    v = jnp.mod(uv[:, 1], 1.0) * h - 0.5
    x0 = jnp.floor(u).astype(jnp.int32)
    y0 = jnp.floor(v).astype(jnp.int32)
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]
    x0w = jnp.mod(x0, w)
    x1w = jnp.mod(x0 + 1, w)
    y0w = jnp.mod(y0, h)
    y1w = jnp.mod(y0 + 1, h)
    c00 = level[y0w, x0w]
    c10 = level[y0w, x1w]
    c01 = level[y1w, x0w]
    c11 = level[y1w, x1w]
    return ((1 - fx) * (1 - fy) * c00 + fx * (1 - fy) * c10
            + (1 - fx) * fy * c01 + fx * fy * c11)


def mip_level_shapes(h: int, w: int, max_levels: int = 16):
    """Static (H_l, W_l) chain matching build_mip_pyramid's [::2]
    decimation (each level is ceil(prev/2))."""
    shapes = [(h, w)]
    while len(shapes) < max_levels and (h > 1 or w > 1):
        h, w = max(1, (h + 1) // 2), max(1, (w + 1) // 2)
        shapes.append((h, w))
    return shapes


def build_atlas_mips(atlas):
    """Mip chain of a [T, H, W, 3] texture atlas as ONE flat array per
    channel: levels (point-decimated, texture.cu:15-31 semantics) are
    flattened [T*H_l*W_l] and concatenated. Per-lane mip selection then
    needs no lax.switch: a level's offset/shape are gathered scalars and
    the bilinear arithmetic stays fully vectorized (see
    render/integrator's bilinear block).

    Returns (mips_r, mips_g, mips_b) flat arrays; the static shape/
    offset tables come from `mip_level_shapes(H, W)`.
    """
    t, h, w = atlas.shape[0], atlas.shape[1], atlas.shape[2]
    chans = {0: [], 1: [], 2: []}
    level = atlas
    for (hl, wl) in mip_level_shapes(h, w):
        assert level.shape[1] == hl and level.shape[2] == wl
        for c in range(3):
            chans[c].append(level[..., c].reshape(-1))
        # Point-decimate keeping the EVEN texel of each pair. The
        # reference's textureDownsampling (texture.cu:15-31) point-
        # samples at output-texel centers, which lands on the ODD input
        # texel -- a one-texel phase offset per level. Irrelevant for
        # parity: the reference configures cudaFilterModePoint on level
        # 0 only and never reads its mips; our "bilinear" tex_filter
        # (the only consumer of this chain) is already a non-parity
        # extension. Documented per ADVICE r4.
        level = level[:, ::2, ::2, :]
    return tuple(jnp.concatenate(chans[c]) for c in range(3))


def sample_mip(levels: Sequence, uv, level_idx, bilinear: bool = True):
    """Fetch from an integer mip level (static shapes per level: the
    level choice is a lax.switch over the chain)."""
    import jax

    fns = [(lambda lv: (lambda uv_: sample_bilinear(lv, uv_) if bilinear
                        else sample_point(lv, uv_)))(lv) for lv in levels]
    return jax.lax.switch(jnp.clip(level_idx, 0, len(levels) - 1), fns, uv)
