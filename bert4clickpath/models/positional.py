"""Position encodings.

* Sinusoidal (reference transformer.py:44-61, Vaswani et al.) — computed once
  as a constant; identical formula (even dims sin, odd dims cos, base 10000).
* Learned (the BERT4Rec paper's choice; the reference left it as a ToDo at
  transformer.py:397) — a (max_len, d_model) table under
  ``params['positions']['embedding']``, initialized N(0, 0.02^2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bert4clickpath.models import layers


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) float32 sinusoidal table."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    i = np.arange(d_model, dtype=np.float32)[None, :]
    angle_rates = 1.0 / np.power(10000.0, (2.0 * (i // 2)) / np.float32(d_model))
    angles = pos * angle_rates
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    return table


def learned_positions_params(key: layers.InitKey, max_len: int, d_model: int) -> dict:
    init = jax.nn.initializers.normal(stddev=0.02)
    return {"embedding": init(layers.param_key(key), (max_len, d_model), jnp.float32)}
