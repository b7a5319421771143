"""NaN-guard utilities."""

import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath.utils import debug


def test_checked_raises_on_nan():
    f = debug.checked(lambda x: jnp.log(x))  # log(-1) -> nan
    assert np.isfinite(float(f(jnp.asarray(2.0))))
    with pytest.raises(Exception):
        f(jnp.asarray(-1.0))


def test_assert_all_finite():
    debug.assert_all_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError):
        debug.assert_all_finite({"a": jnp.asarray([1.0, float("nan")])}, "params")


def test_finite_guard_step():
    def bad_step(state, batch, rng):
        return state, jnp.asarray(float("inf"))

    guarded = debug.finite_guard_step(bad_step)

    class S:
        step = jnp.asarray(3)

    with pytest.raises(FloatingPointError):
        guarded(S(), None, None)
