"""Device mesh construction.

Axes (the framework's parallelism vocabulary, SURVEY.md §2 rows 19-20):
  "data"  — stream/window rows (the DP/SP analog: each chip owns a row block
            of the window, the moral equivalent of sequence/context sharding)
  "model" — feature/hash dimensions (the TP analog: hashed tag/text feature
            columns sharded, contractions psum over this axis)

The reference has no distributed layer at all (single NumPy process); the
multi-chip story is new work built on FD mergeability.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    use = devices[: n_data * n_model]
    arr = np.array(use).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))
