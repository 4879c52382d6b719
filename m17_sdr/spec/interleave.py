"""M17 quadratic interleaver on 368 bits.

Reference: m17_interleave.cpp:3-12.  pi(i) = (45*i + 92*i^2) mod 368 is an
involution (pi(pi(i)) == i), which is why the reference uses the identical
scatter for both directions.  Here a scatter `out[pi[i]] = in[i]` is the
gather `out = in[pi]` precisely because pi is self-inverse; one static
gather handles any batch shape and fuses with neighbours.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .constants import PAYLOAD_SOFT_BITS

_i = np.arange(PAYLOAD_SOFT_BITS, dtype=np.int64)
INTERLEAVE_PERM = ((45 * _i + 92 * _i * _i) % PAYLOAD_SOFT_BITS).astype(np.int32)

assert np.array_equal(INTERLEAVE_PERM[INTERLEAVE_PERM], _i), "pi must be an involution"


def interleave(x: jnp.ndarray) -> jnp.ndarray:
    """Apply pi to the last axis (length 368). Works on bits or soft bits."""
    return jnp.take(x, jnp.asarray(INTERLEAVE_PERM), axis=-1)


# Self-inverse: one function serves both directions, as in the reference.
deinterleave = interleave
