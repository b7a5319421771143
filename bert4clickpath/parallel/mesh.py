"""Device-mesh construction.

The comms tier the reference never had (its only distribution was
single-host MirroredStrategy, source/main.py:46-57): a logical
``(data, model)`` mesh over which

* the batch shards on ``data`` (DP),
* embedding tables / tied output projections row-shard on ``model``
  (the embedding-parallel "EP" of this domain, SURVEY.md §2.2),

with all cross-device traffic expressed as XLA collectives (psum /
all_gather). Devices are placed in ``jax.devices()`` order, without regard
to topology: the cards of one host are joined all to all (NVLink), so any
order gives every pair the same link.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from bert4clickpath.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    cfg: Optional[MeshConfig] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, model) mesh. With no config, all devices go data-parallel."""
    devices = list(devices) if devices is not None else jax.devices()
    if cfg is None:
        cfg = MeshConfig(data=len(devices), model=1)
    if cfg.num_devices != len(devices):
        raise ValueError(
            f"mesh {cfg.data}x{cfg.model} needs {cfg.num_devices} devices, "
            f"got {len(devices)}"
        )
    arr = np.asarray(devices).reshape(cfg.data, cfg.model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def initialize_distributed() -> None:
    """Multi-host entry: call once per process before device use
    (single-controller-per-host SPMD; replaces TF_CONFIG parsing at
    reference source/main.py:172-180)."""
    import os

    if "JAX_COORDINATOR_ADDRESS" in os.environ or "COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize()
