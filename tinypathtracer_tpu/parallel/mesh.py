"""Device meshes for distributed rendering.

The reference has no multi-device story at all (SURVEY.md par. 2: its
only parallelism is single-GPU SIMT). This design scales over a
`jax.sharding.Mesh` with two logical axes:

  * "data"   -- pixel/ray batches (the DP axis: each device owns a
                slice of the film, scene + BVH replicated, no
                communication in the forward pass)
  * "sample" -- samples-per-pixel (the "TP/SP analogue": devices render
                disjoint spp slices of the SAME pixels and psum the
                radiance accumulator)

Multi-host runs initialize jax.distributed outside and simply see more
devices; XLA compiles the collectives (NCCL between GPUs), so there is
no transport code to manage. The cards of one host are joined all to
all, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def make_mesh(n_data: Optional[int] = None, n_sample: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("data", "sample") mesh over the available devices.

    n_data defaults to (device_count // n_sample). A (N, 1) mesh is
    pure pixel DP; (N/2, 2) additionally splits spp in half across
    pairs of devices.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_sample
    n = n_data * n_sample
    if n > len(devices):
        raise ValueError(f"mesh {n_data}x{n_sample} needs {n} devices, "
                         f"have {len(devices)}")
    grid = np.array(devices[:n]).reshape(n_data, n_sample)
    return Mesh(grid, (DATA_AXIS, SAMPLE_AXIS))
