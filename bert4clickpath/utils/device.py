"""Device and dtype helpers shared by the library and its scripts."""

from __future__ import annotations

import subprocess

import jax
import jax.numpy as jnp


def compute_dtype(config) -> jnp.dtype:
    """The activation/matmul dtype a ModelConfig asks for."""
    return jnp.bfloat16 if config.dtype == "bfloat16" else jnp.float32


def backend_dtype() -> str:
    """The ModelConfig dtype for the default backend: bf16 operands with f32
    accumulation on the GPU's tensor cores; float32 on the CPU, where bf16
    buys nothing and tests compare against f32 references."""
    return "bfloat16" if jax.default_backend() == "gpu" else "float32"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them, to be
    printed beside every number measured on it (a card held below its
    maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
