"""High-rate front end: batched decimating FIR (the Pluto-rate path).

Reference: radio.cpp:18-50 + 157-177 -- the Pluto backend streams at
384 kS/s and the HAL filters it down to the modem's 48 kS/s with a
31-tap low-pass FIR decimating by 8, applied blockwise with a sliding
history.  Here the same contract is one batched strided convolution
over [B, 2, T] planar IQ with an explicit [B, 2, ntaps-1] carry, so
long captures split into blocks reproduce the unsplit output exactly
(the overlap-save halo of SURVEY.md section 5.7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .filters import lpf_filter, normalize_gain

PLUTO_DECIMATION = 8          # 384 kS/s -> 48 kS/s (radio.cpp:59-65)
PLUTO_FIR_TAPS = 31           # radio.cpp:18 (NDEC_TAPS)


@functools.lru_cache(maxsize=None)
def pluto_dec_taps() -> np.ndarray:
    """The x8 decimation low-pass: 31-tap sinc at 1/8 bandwidth, unit
    DC gain (the reference scales its int16 taps by 1/0x8000,
    radio.cpp:20-29)."""
    return normalize_gain(lpf_filter(1.0 / PLUTO_DECIMATION, PLUTO_FIR_TAPS))


def decimate_init(batch: int, ntaps: int = PLUTO_FIR_TAPS) -> jnp.ndarray:
    """Zero FIR history carry [B, 2, ntaps-1]."""
    return jnp.zeros((batch, 2, ntaps - 1), jnp.float32)


@functools.partial(jax.jit, static_argnames=("factor",))
def fir_decimate(
    iq2: jnp.ndarray,
    taps: jnp.ndarray,
    tail: jnp.ndarray,
    factor: int = PLUTO_DECIMATION,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[B, 2, T] planar IQ -> ([B, 2, T//factor], new tail).

    y[n] = sum_k h[k] * x[n*factor - k], streaming across blocks via the
    (ntaps-1)-sample tail exactly like the HAL's persistent m_dec_buf
    (radio.cpp:31-50).  T must be a multiple of `factor`.
    """
    b, _, t = iq2.shape
    assert t % factor == 0
    ntaps = taps.shape[0]
    x = jnp.concatenate([tail, iq2], axis=-1)          # [B, 2, T+ntaps-1]
    # correlation with reversed taps == FIR sum h[k] x[n-k]
    kern = taps[::-1].reshape(1, 1, ntaps)
    y = jax.lax.conv_general_dilated(
        x.reshape(b * 2, 1, t + ntaps - 1),
        kern,
        window_strides=(factor,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        # HIGHEST: a float32 conv may otherwise run in TF32 on a GPU;
        # the decimated stream must match an unsplit run's
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(b, 2, -1)
    # VALID + the (ntaps-1) tail prefix => output m is the FIR at input
    # position m*factor of this block, filtered against full history;
    # with T % factor == 0 the comb phase is continuous across blocks.
    return y, x[..., -(ntaps - 1):]


@functools.partial(jax.jit, static_argnames=("factor",))
def decimate_pluto(iq2: jnp.ndarray, tail: jnp.ndarray,
                   factor: int = PLUTO_DECIMATION):
    """The radio-HAL x8 path with the standard taps."""
    return fir_decimate(iq2, jnp.asarray(pluto_dec_taps()), tail, factor)
