"""Persistent XLA compilation cache for the entry scripts.

Executables are keyed by program hash, so a re-run of an unchanged program
(bench.py, the train driver, profile_step.py) skips its compiles.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; this module sets
  nothing.
* Otherwise the cache lives at the fixed ``<repo>/.jax_compile_cache``. The
  directory must not move between runs, or no entry is ever found again.
* Never on the CPU backend: XLA:CPU entries embed host machine features
  that are not part of the cache key, so an entry written on one host can
  crash (SIGILL) when loaded on another. CPU compiles are fast anyway.
* Opt-out: ``B4CP_NO_COMPILE_CACHE=1`` (e.g. to measure cold compiles).
"""

from __future__ import annotations

import os

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_compile_cache",
)


def enable(cache_dir: str | None = None) -> str | None:
    """Turn the persistent compilation cache on; call before the first jit
    execution. Returns the cache directory in use, or None when the cache
    is off (opted out, or the CPU backend)."""
    if os.environ.get("B4CP_NO_COMPILE_CACHE"):
        return None
    if os.environ.get(ENV_DIR):
        return os.environ[ENV_DIR]
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = cache_dir or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
