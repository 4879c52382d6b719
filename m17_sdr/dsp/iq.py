"""Planar IQ representation: float32 [..., 2, T] (plane 0 = re, 1 = im).

Planar float pairs keep the time axis contiguous in each plane, and
every complex op lowers to plain float math with no interleaving.
Host code converts to/from numpy complex at the boundary only.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def from_complex(x) -> jnp.ndarray:
    """numpy/jnp complex [..., T] -> float32 [..., 2, T]."""
    x = np.asarray(x)
    return jnp.asarray(
        np.stack([np.real(x), np.imag(x)], axis=-2).astype(np.float32))


def to_complex(x) -> np.ndarray:
    """[..., 2, T] -> numpy complex64 [..., T] (host side)."""
    x = np.asarray(x)
    return (x[..., 0, :] + 1j * x[..., 1, :]).astype(np.complex64)


def make(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([re, im], axis=-2)


def re(x: jnp.ndarray) -> jnp.ndarray:
    return x[..., 0, :]


def im(x: jnp.ndarray) -> jnp.ndarray:
    return x[..., 1, :]


def magnitude(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(re(x) ** 2 + im(x) ** 2)


def conj_mul_im(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Im(conj(a) * b) -- the quadrature discriminator cross product."""
    return re(a) * im(b) - im(a) * re(b)


def rotate(x: jnp.ndarray, cos_ph: jnp.ndarray, sin_ph: jnp.ndarray) -> jnp.ndarray:
    """x * exp(j*phase): complex rotation by per-sample phase."""
    return make(
        re(x) * cos_ph - im(x) * sin_ph,
        re(x) * sin_ph + im(x) * cos_ph,
    )


def from_phase(phase: jnp.ndarray) -> jnp.ndarray:
    """exp(j*phase) as planar IQ [..., 2, T] from phase [..., T]."""
    return make(jnp.cos(phase), jnp.sin(phase))
