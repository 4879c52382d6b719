"""RX front end: AFC mixer, hard limiter, FM discriminator, decimation.

Reference: m17_dsp.cpp (dsp_nco_mixer 390-408, dsp_limit 412-419,
dsp_arctan_disc2 194-222) and the AFC loop in radio.cpp:196-208.

IQ is planar float32 [B, 2, T] (see dsp/iq.py).  Everything is
elementwise over the block; the only
sequential state is a 2-sample discriminator tail, the AFC NCO phase,
and the AFC frequency estimate -- carried per channel in
RxFrontEndState.

The discriminator is the reference's division-free cross-product form:
expanding dsp_arctan_disc2's a/b terms gives

    u[n] = Im( conj(z[n-1]) * z[n] ) + Im( conj(z[n-2]) * z[n-1] )

i.e. a 2-tap boxcar of the one-sample quadrature discriminator, scaled
by 0.5.  After the unit-magnitude limiter this approximates the average
phase increment per sample.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..spec.constants import RX_DECIMATION
from . import iq as iqmod

AFC_LOOP_GAIN = 0.1  # radio.cpp:198

# One-pole gain for the carried DC estimate used while a frame is being
# received.  The reference never subtracts the instantaneous block mean
# -- it feeds DC into a slow AFC integrator gated by in_frame
# (m17_dsp.cpp:213-215, radio.cpp:196-208).  A raw block-mean
# subtraction corrupts any block whose *symbol content* has nonzero
# mean (the EOT pattern averages +2.25 symbol units,
# m17_tx_routines.cpp:242-255), shifting every symbol in that block.
# Scheme here: while UNLOCKED, subtract the instantaneous block mean
# (hunt content is carrier/preamble/noise -- all zero-symbol-mean, so
# the mean IS the carrier offset, and cold starts self-correct within
# one block); while LOCKED, subtract the carried slow estimate seeded
# at acquisition, so in-frame content with nonzero symbol mean (EOT)
# cannot shift the block it lives in.
DC_SMOOTH_GAIN = 0.25

# software AGC (the Lime path's RSSI-driven gain servo + the Pluto
# path's RSSI scaling for the GUI bar, radio_rssi_update
# radio.cpp:224-265): keep the smoothed input level inside
# [AGC_LOW, AGC_HIGH] by stepping a per-channel digital gain.
RSSI_SMOOTH = 0.9
AGC_LOW, AGC_HIGH = 0.25, 0.75
AGC_STEP = 1.05
AGC_GAIN_MIN, AGC_GAIN_MAX = 1.0 / 64.0, 64.0


class RxFrontEndState(NamedTuple):
    """Per-channel front-end carry."""

    disc_tail: jnp.ndarray   # [B, 2, 2] planar: z[n-2], z[n-1]
    nco_phase: jnp.ndarray   # [B] AFC mixer phase accumulator
    afc_delta: jnp.ndarray   # [B] AFC frequency estimate (rad/sample)
    rssi: jnp.ndarray        # [B] smoothed signal level (linear)
    agc_gain: jnp.ndarray    # [B] software AGC gain recommendation
    dc_est: jnp.ndarray      # [B] smoothed discriminator DC estimate
    dc_seeded: jnp.ndarray   # [B] bool: dc_est holds a measurement

    @staticmethod
    def init(batch: int) -> "RxFrontEndState":
        return RxFrontEndState(
            disc_tail=jnp.zeros((batch, 2, 2), dtype=jnp.float32),
            nco_phase=jnp.zeros((batch,), dtype=jnp.float32),
            afc_delta=jnp.zeros((batch,), dtype=jnp.float32),
            rssi=jnp.zeros((batch,), dtype=jnp.float32),
            agc_gain=jnp.ones((batch,), dtype=jnp.float32),
            dc_est=jnp.zeros((batch,), dtype=jnp.float32),
            dc_seeded=jnp.zeros((batch,), dtype=bool),
        )


def scale_int16(iq_int16: jnp.ndarray) -> jnp.ndarray:
    """int16 interleaved IQ [..., T, 2] -> planar float [..., 2, T],
    scaled by 3e-5 (dsp_short_to_float, m17_dsp.cpp:136-141)."""
    return jnp.moveaxis(iq_int16.astype(jnp.float32) * 3.0e-5, -1, -2)


def limit(iq2: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Unit-magnitude hard limiter (dsp_limit, m17_dsp.cpp:412-419)."""
    mag = jnp.maximum(iqmod.magnitude(iq2), eps)
    return iq2 / mag[..., None, :]


def nco_mix(iq2: jnp.ndarray, phase0: jnp.ndarray, delta: jnp.ndarray):
    """Rotate [B, 2, T] IQ by a per-channel linear phase ramp (AFC mixer,
    dsp_nco_mixer m17_dsp.cpp:390-408).  Returns (mixed, final phase)."""
    t = jnp.arange(iq2.shape[-1], dtype=jnp.float32)
    phase = phase0[:, None] + delta[:, None] * t
    mixed = iqmod.rotate(iq2, jnp.cos(phase), jnp.sin(phase))
    end = jnp.mod(phase0 + delta * iq2.shape[-1], 2.0 * np.pi)
    end = jnp.where(jnp.isnan(end), 0.0, end)  # NaN scrub (m17_dsp.cpp:407)
    return mixed, end


@functools.partial(jax.jit, static_argnames=("afc_enabled",))
def rx_front_end(
    iq2: jnp.ndarray,
    state: RxFrontEndState,
    in_frame: jnp.ndarray,
    afc_enabled: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, RxFrontEndState]:
    """Full front end for one [B, 2, T] block (T % 5 == 0).

    Returns (soft samples [B, T//5] at 2 samples/symbol, dc offset [B],
    new state).  Mirrors m17_dsp_rx (m17_dsp.cpp:461-476) minus the
    timing/framer stages, which live in frame/receiver.py.

    `in_frame` [B] bool gates the AFC integrator exactly like
    radio_afc/radio_get_afc_delta (radio.cpp:196-208): the loop only
    integrates while a frame is being received, and the estimate is
    dropped when AFC is off.
    """
    b, _, t = iq2.shape
    assert t % RX_DECIMATION == 0

    # Planar int16 IQ is the device-resident wire format (the radio HAL
    # contract is 48 kHz int16 IQ, radio.cpp:157-177): accept it
    # directly and fuse the reference's short->float scale
    # (dsp_short_to_float, m17_dsp.cpp:136-141) into the front end.
    # Halves the block's HBM read -- the front end is input-read-bound.
    if iq2.dtype == jnp.int16:
        iq2 = iq2.astype(jnp.float32) * 3.0e-5

    # RSSI + software AGC on the raw input level (radio.cpp:224-265).
    # The limiter makes the demod gain-invariant, so agc_gain is a
    # *recommendation* for whatever feeds the pipeline (a real SDR's
    # hardware gain, or a file source's scaling), not applied here.
    level = jnp.mean(iqmod.magnitude(iq2), axis=-1)
    # rssi == 0 marks a cold channel: seed with the first measured level
    # instead of smoothing up from zero, so the gain servo doesn't slam
    # to max during the meter's own convergence transient.
    rssi = jnp.where(state.rssi > 0.0,
                     RSSI_SMOOTH * state.rssi + (1.0 - RSSI_SMOOTH) * level,
                     level)
    agc = jnp.where(rssi < AGC_LOW, state.agc_gain * AGC_STEP,
                    jnp.where(rssi > AGC_HIGH,
                              state.agc_gain / AGC_STEP, state.agc_gain))
    agc = jnp.clip(agc, AGC_GAIN_MIN, AGC_GAIN_MAX)

    if afc_enabled:
        delta = jnp.where(in_frame, state.afc_delta, 0.0)
        iq2, nco_phase = nco_mix(iq2, state.nco_phase, delta)
    else:
        nco_phase = state.nco_phase

    z = limit(iq2)

    # discriminator with 2-sample planar history
    zh = jnp.concatenate([state.disc_tail, z], axis=-1)   # [B, 2, T+2]
    z0 = zh[..., 1:-1]   # z[n-1]
    z1 = zh[..., :-2]    # z[n-2]
    u = (iqmod.conj_mul_im(z0, z) + iqmod.conj_mul_im(z1, z0)) * 0.5

    # DC offset over the whole block feeds the AFC (m17_dsp.cpp:213-215)
    offset = jnp.mean(u, axis=-1)

    # DC handling split by lock state (see DC_SMOOTH_GAIN comment):
    # unlocked channels track the instantaneous block mean (and re-seed
    # the carried estimate); locked channels subtract the carried slow
    # estimate so nonzero-symbol-mean content (EOT) can't shift its own
    # block, and update it slowly for residual drift.
    dc_used = jnp.where(in_frame & state.dc_seeded, state.dc_est, offset)
    dc_est = jnp.where(
        in_frame & state.dc_seeded,
        state.dc_est + DC_SMOOTH_GAIN * (offset - state.dc_est),
        offset,
    )

    # decimate by 5: the reference's count-mod-5 emitter with zero
    # starting phase picks indices 4, 9, ... (m17_dsp.cpp:206-209);
    # block lengths are multiples of 5 so the phase never drifts.
    dec = u[:, RX_DECIMATION - 1::RX_DECIMATION] - dc_used[:, None]

    if afc_enabled:
        # integrate only in frame; RESET out of frame exactly like the
        # reference (radio_get_afc_delta zeroes m_afc_delta whenever
        # read while not in frame, radio.cpp:201-208) -- a retained
        # estimate would kick the next session's first locked block by
        # the PREVIOUS station's frequency offset.
        afc_delta = jnp.where(
            in_frame, state.afc_delta - offset * AFC_LOOP_GAIN, 0.0
        )
        # feed-forward, in-frame only: the NCO delta and the
        # discriminator DC live in the same units (rad/sample of
        # residual offset), so a delta step of d shifts the next
        # block's DC by exactly d -- predict it instead of letting
        # dc_est lag the AFC transient.  (Out of frame the reset above
        # must not bleed into the freshly reseeded dc_est.)
        dc_est = dc_est + jnp.where(
            in_frame, afc_delta - state.afc_delta, 0.0)
    else:
        afc_delta = jnp.zeros_like(state.afc_delta)

    new_state = RxFrontEndState(
        disc_tail=z[..., -2:], nco_phase=nco_phase, afc_delta=afc_delta,
        rssi=rssi, agc_gain=agc,
        dc_est=dc_est, dc_seeded=jnp.ones_like(state.dc_seeded),
    )
    return dec, offset, new_state
