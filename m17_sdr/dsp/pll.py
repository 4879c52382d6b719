"""Dormant-alternate RX front ends: PLL discriminator + half-band filter.

The reference carries two alternate front-end paths that are compiled
but never selected (SURVEY.md section 2 row 3 marks them dormant):

- a phase-locked-loop FM discriminator, ``dsp_pll_disc``
  (m17_dsp.cpp:226-291): per sample the input is rotated by an NCO
  phase ``z``, the phase-detector output ``val = Re + Im`` of the
  rotated sample both *is* the demodulated output and drives the NCO
  (``z += val * K``, K = 3e-8 at int16 sample scale,
  m17_dsp.cpp:19-20, 260-291); the output is decimated by 5 and its
  block mean is the DC offset fed to the AFC integrator
  (radio.cpp:196-208), exactly like the quadrature path.
- a half-band FIR that exploits the zero even-offset taps
  (m17_halfband_filter, m17_dsp.cpp:319-343): compact coefficients
  ``c[0]`` (center), ``c[j]`` at offsets +/-(2j-1), int16 weights with
  a >>15 output shift.

Both are capability parity items, not the hot path: the PLL is a true
per-sample feedback loop, so it is formulated as a batched
``lax.scan`` over time with the NCO phase as the per-channel carry --
correct but sequential, the same trade the reference made (its comment
at m17_dsp.cpp:19 notes the stability bound).  The half-band filter is
a plain batched convolution; XLA sees the zero taps as multiplies by
zero, so no special kernel is warranted.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..spec.constants import RX_DECIMATION

# m17_dsp.cpp:20 -- loop gain for the fcmplx overload (260-291), which
# applies K directly to the phase accumulator at int16 sample scale.
PLL_LOOP_GAIN = 3.0e-8


class PllState(NamedTuple):
    """Per-channel PLL carry: the NCO phase accumulator (radians)."""

    z: jnp.ndarray  # [B] float32

    @staticmethod
    def init(batch: int) -> "PllState":
        return PllState(z=jnp.zeros((batch,), dtype=jnp.float32))


def pll_disc(
    iq2: jnp.ndarray,
    state: PllState,
    k: float = PLL_LOOP_GAIN,
    decimation: int = RX_DECIMATION,
) -> tuple[jnp.ndarray, jnp.ndarray, PllState]:
    """Batched PLL FM discriminator (m17_dsp.cpp:260-291).

    iq2: planar [B, 2, T].  Returns (disc [B, T//decimation],
    dc_offset [B], new state).  Per sample: rotate the input by the
    NCO phase, ``val = Re + Im`` of the rotated sample, advance the
    NCO by ``val * k``.  Output is decimated (the reference keeps
    sample indices i % 5 == 4) and the *undecimated* block mean is
    returned as the DC/AFC measurement; DC is subtracted from the
    decimated output, as in the reference (m17_dsp.cpp:279-289).

    Block lengths must be a multiple of ``decimation``: the reference's
    ``static int count`` (m17_dsp.cpp:261, 274) carries the decimation
    phase across calls, while this function restarts it each block (a
    per-channel carried phase would make the output length depend on
    runtime state, which jit-fixed shapes cannot express).  For
    multiple-of-5 blocks the two are identical -- every real block size
    in this framework (BLOCK_SAMPLES = 1920) satisfies this, and the
    assert below keeps the equivalence honest.
    """
    b, _, t = iq2.shape
    assert t % decimation == 0, (
        f"pll_disc needs block length % {decimation} == 0 to match the "
        f"reference's carried decimation phase (got {t})")
    xs = jnp.moveaxis(iq2, -1, 0)  # [T, B, 2]

    def step(z, x):
        cv, sv = jnp.cos(z), jnp.sin(z)
        re = cv * x[:, 0] - sv * x[:, 1]
        im = cv * x[:, 1] + sv * x[:, 0]
        val = re + im
        z = z + val * k
        return z, val

    z, vals = jax.lax.scan(step, state.z, xs)  # vals: [T, B]
    vals = vals.T  # [B, T]
    dc = jnp.mean(vals, axis=-1)
    # keep i % decimation == (decimation-1), matching the reference's
    # count-then-test order (m17_dsp.cpp:272-274)
    out = vals[:, decimation - 1::decimation] - dc[:, None]
    # phase wrap (modf equivalent, m17_dsp.cpp:280-283) keeps z finite
    two_pi = jnp.float32(2.0 * np.pi)
    z = z - two_pi * jnp.trunc(z / two_pi)
    return out, dc, PllState(z=z)


def expand_halfband(compact: np.ndarray, flen: int) -> np.ndarray:
    """Expand compact half-band weights to the full flen-tap kernel.

    ``compact[0]`` is the center tap; ``compact[j]`` (j >= 1) sits at
    offsets +/-(2j-1) from the center (m17_halfband_filter's pointer
    walk, m17_dsp.cpp:326-339).  All even offsets are zero -- the
    half-band property the reference's loop exploits.

    Only in-window taps are accepted: the reference's HB_FN/2 = 31
    compact entries index the full coefficient array, but its inner
    loop reads entries whose offsets fall OUTSIDE the centered
    flen-tap window (out-of-window pointer walk); reproducing that
    would read past the kernel, so callers must pass the in-window
    subset (the center tap plus the odd offsets <= flen//2: 17 entries
    for flen = 63).
    """
    assert flen % 2 == 1
    max_entries = (flen // 2 + 1) // 2 + 1
    assert len(compact) <= max_entries, (
        f"{len(compact)} compact half-band entries exceed the centered "
        f"{flen}-tap window (max {max_entries}); the reference's loop "
        "indexes outside the window there, which is not reproduced")
    h = np.zeros(flen, dtype=np.float32)
    c = flen // 2
    h[c] = compact[0]
    for j in range(1, len(compact)):
        off = 2 * j - 1
        h[c + off] = compact[j]
        h[c - off] = compact[j]
    return h


def design_halfband(flen: int = 63) -> np.ndarray:
    """Windowed-sinc half-band low-pass (cutoff fs/4) as int16-scaled
    compact weights, the shape m17_dsp.cpp's HB_FN=63 path expects."""
    assert flen % 2 == 1
    n = np.arange(flen) - flen // 2
    with np.errstate(invalid="ignore"):
        sinc = np.where(n == 0, 0.5, np.sin(np.pi * n / 2) / (np.pi * n))
    win = np.hamming(flen)
    h = sinc * win
    h = h / h.sum()
    compact = [h[flen // 2]]
    off = 1
    while flen // 2 + off < flen:
        compact.append(h[flen // 2 + off])
        off += 2
    return np.round(np.asarray(compact) * 32768.0).astype(np.int16)


def halfband_filter(iq2: jnp.ndarray, compact: np.ndarray,
                    flen: int = 63) -> jnp.ndarray:
    """Batched half-band FIR (m17_halfband_filter, m17_dsp.cpp:319-343).

    iq2: planar int16-valued [B, 2, T] (float carrier is fine; the
    arithmetic mirrors the reference's int32 accumulate + >>15).
    Valid convolution: output length T - flen + 1, matching the
    reference's ``out[i] = sum_j in[i+j] * h[j]`` indexing.

    Tolerance note: the reference accumulates in int32 before the
    >>15 shift; this float32 accumulation can differ from the exact
    integer sum by +-1 LSB in the worst case (tap sums near 2^35
    exceed float32's 24-bit mantissa).  This dormant-alternate path
    trades that last bit for the batched conv formulation; the live
    quadrature front end is unaffected.
    """
    h = jnp.asarray(expand_halfband(np.asarray(compact, np.float32), flen))
    b, _, t = iq2.shape
    x = iq2.reshape(b * 2, 1, t)
    # correlation; h is symmetric so orientation is immaterial
    y = jax.lax.conv_general_dilated(
        x, h[None, None, :], window_strides=(1,), padding="VALID")
    out = jnp.floor(y / 32768.0)  # int32 arithmetic >> 15
    return out.reshape(b, 2, t - flen + 1)
