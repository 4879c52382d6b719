"""PRBS9 (x^9 + x^5 + 1) for BERT frames.

Reference: m17_prbs9.cpp.  The 511-bit sequence is generated once
(lines 16-26); TX loads consecutive windows (27-32); RX hunts for
alignment with an 18-bit match/mismatch hysteresis (40-64).

Batched: the sequence is a static table, so TX windows are gathers and
the BER check over a whole batch of received bit streams reduces to
correlation against all 511 cyclic shifts at once (one matmul) instead
of a serial hysteresis FSM -- same decision, no scan.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

PRBS9_LEN = 511
BERT_FRAME_BITS = 197  # PRBS bits per BERT frame (m17_tx_routines.cpp:228)


def _generate() -> np.ndarray:
    seq = np.zeros(PRBS9_LEN, dtype=np.uint8)
    sr = 0x01
    for i in range(PRBS9_LEN):
        bit = ((sr >> 8) ^ (sr >> 4)) & 1
        sr = ((sr << 1) | bit) & 0x1FF
        seq[i] = bit
    return seq


PRBS9_SEQUENCE = _generate()


def tx_window(start: int | jnp.ndarray, length: int) -> jnp.ndarray:
    """PRBS9 bits [start, start+length) with wraparound.

    Reference: m17_prbs9_tx_load (m17_prbs9.cpp:27-32).  `start` may be a
    batched array of per-channel positions.
    """
    idx = (jnp.arange(length) + jnp.asarray(start)[..., None]) % PRBS9_LEN
    return jnp.take(jnp.asarray(PRBS9_SEQUENCE), idx, axis=-1)


def align_and_count_errors(rx_bits: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best-alignment BER count for [..., N] received hard bits.

    Correlates against all 511 cyclic shifts simultaneously: the shift
    with the fewest mismatches wins.  Returns (errors [...], shift [...]).
    This replaces the serial sync-hunting checker (m17_prbs9.cpp:40-64)
    with a branchless batched form; for a correctly received stream both
    report the same error count.
    """
    n = rx_bits.shape[-1]
    idx = (np.arange(PRBS9_LEN)[:, None] + np.arange(n)[None, :]) % PRBS9_LEN
    shifted = PRBS9_SEQUENCE[idx].astype(np.float32)          # [511, N]
    rx = (rx_bits.astype(jnp.float32) * 2.0 - 1.0)            # +-1
    ref = jnp.asarray(shifted * 2.0 - 1.0)
    # matches - mismatches = rx . ref ; errors = (N - dot) / 2.  Exact
    # at any matmul precision, TF32 included: +-1 operands, f32 sums of
    # at most N < 2^24 terms.
    dot = rx @ ref.T                                          # [..., 511]
    errors = (n - dot) / 2.0
    best = jnp.argmin(errors, axis=-1)
    return jnp.take_along_axis(errors, best[..., None], axis=-1)[..., 0].astype(
        jnp.int32
    ), best.astype(jnp.int32)


# Stream-checker thresholds (fractions of BERT_FRAME_BITS).  While
# synced, a frame is counted at the PREDICTED alignment unless its
# error count implies the alignment was lost (a quarter of the bits
# wrong -- far beyond any usable link); re-acquisition demands a
# clearly-good match, below the ~77-error floor that the minimum over
# 510 WRONG shifts of a random 197-bit frame reaches (which is why
# per-frame best-shift alignment alone under-reports a dead link).
RESYNC_FRAC = 0.25
ACCEPT_FRAC = 0.20


def check_stream(rx_frames: np.ndarray) -> tuple[int, int, int]:
    """BER count for a SEQUENCE of received BERT frames [NF, 197].

    The serial equivalent of the reference's sync-hunting checker
    (m17_prbs9.cpp:40-64): acquire alignment once on a clearly-good
    frame, then count each following frame's errors at the PREDICTED
    shift (TX advances 197 bits/frame through the 511-bit sequence),
    re-acquiring only when the prediction fails -- a dropped frame
    breaks the prediction and costs one resync, like the reference's
    hysteresis.  Frames received while no alignment holds count at the
    50% a dead link truly delivers; aligning each frame independently
    to its best of 511 shifts (align_and_count_errors) would cap them
    near the min-over-wrong-shifts floor (~39% of bits) and
    under-report exactly the failing links a BERT exists to measure.

    Returns (bit_errors, bits_counted, unsynced_frames).  Frames
    received while no alignment holds are booked at the estimated 50%
    a dead link delivers, not a measured mismatch; `unsynced_frames`
    counts them so callers can flag how much of `bit_errors` is
    estimated rather than measured error mass.
    """
    nf, n = np.asarray(rx_frames).shape
    per_frame = check_stream_frames(rx_frames)
    unsynced = int(np.sum(per_frame < 0))
    errors = int(np.sum(np.where(per_frame < 0, (n + 1) // 2, per_frame)))
    return errors, nf * n, unsynced


def check_stream_frames(rx_frames: np.ndarray) -> np.ndarray:
    """Per-frame error bookings of the check_stream walk: the measured
    count for aligned frames, -1 for frames where no alignment held
    (booked at the estimated 50% rate by check_stream)."""
    rx = np.asarray(rx_frames, dtype=np.uint8)
    nf, n = rx.shape
    idx = (np.arange(PRBS9_LEN)[:, None] + np.arange(n)[None, :]) % PRBS9_LEN
    shifted = PRBS9_SEQUENCE[idx]                            # [511, N]
    errs = (rx[:, None, :] != shifted[None, :, :]).sum(axis=-1)

    resync = int(RESYNC_FRAC * n)
    accept = int(ACCEPT_FRAC * n)
    synced = False
    shift = 0
    out = np.zeros(nf, np.int64)
    for f in range(nf):
        e_best = int(errs[f].min())
        s_best = int(errs[f].argmin())
        if synced and int(errs[f, shift]) <= resync:
            out[f] = int(errs[f, shift])
            shift = (shift + n) % PRBS9_LEN
        elif e_best <= accept:
            out[f] = e_best
            shift = (s_best + n) % PRBS9_LEN
            synced = True
        else:
            out[f] = -1
            synced = False
    return out


def check_stream_device(bv, bb):
    """check_stream for a whole batch ON DEVICE (jnp, scan-based).

    bv [B, S] bool frame-valid slots, bb [B, S, 197] decoded bit
    frames (slot order = arrival order).  Returns (errors [B],
    bits [B], unsynced [B]) int32 -- the same accounting as the numpy
    check_stream walk (asserted equal in tests/test_spec.py), but
    expressed as one mismatch matmul + a lax.scan over slots so a
    mesh-sharded BER sweep can psum the counters without ever leaving
    the device (BASELINE config 5; SURVEY.md section 5.8 names this
    all_reduce).
    """
    import jax

    b, s = bv.shape
    n = BERT_FRAME_BITS
    resync = int(RESYNC_FRAC * n)
    accept = int(ACCEPT_FRAC * n)

    # compact valid frames to the slot front, preserving order
    order = jnp.argsort(~bv, axis=-1, stable=True)
    comp = jnp.take_along_axis(bb, order[..., None], axis=1)
    counts = jnp.sum(bv.astype(jnp.int32), axis=-1)          # [B]

    # mismatch count against every cyclic shift in one matmul:
    # errs[f, k] = sum_n seq_k[n] + sum_n b[n] * (1 - 2 seq_k[n]).
    # Exact at any matmul precision, TF32 included: 0/1 and +-1
    # operands, f32 sums of at most N < 2^24 terms.
    idx = (np.arange(PRBS9_LEN)[:, None]
           + np.arange(n)[None, :]) % PRBS9_LEN
    shifted = PRBS9_SEQUENCE[idx].astype(np.float32)         # [511, N]
    mat = jnp.asarray((1.0 - 2.0 * shifted).T)               # [N, 511]
    base = jnp.asarray(shifted.sum(axis=1))                  # [511]
    errs = (comp.astype(jnp.float32) @ mat + base[None, None, :]
            ).astype(jnp.int32)                              # [B, S, 511]

    def step(carry, xs):
        synced, shift, err_a, bit_a, uns_a = carry
        e_row, live = xs                                     # [B,511], [B]
        e_pred = jnp.take_along_axis(e_row, shift[:, None], axis=-1)[:, 0]
        e_best = jnp.min(e_row, axis=-1)
        s_best = jnp.argmin(e_row, axis=-1).astype(jnp.int32)
        re_ok = synced & (e_pred <= resync)
        ac_ok = (~re_ok) & (e_best <= accept)
        lost = ~re_ok & ~ac_ok
        booked = jnp.where(re_ok, e_pred,
                           jnp.where(ac_ok, e_best, (n + 1) // 2))
        shift2 = jnp.where(re_ok, (shift + n) % PRBS9_LEN,
                           jnp.where(ac_ok, (s_best + n) % PRBS9_LEN,
                                     shift))
        synced2 = re_ok | ac_ok
        upd = live
        return ((jnp.where(upd, synced2, synced),
                 jnp.where(upd, shift2, shift),
                 err_a + jnp.where(upd, booked, 0),
                 bit_a + jnp.where(upd, n, 0),
                 uns_a + jnp.where(upd & lost, 1, 0)), None)

    live = (jnp.arange(s)[None, :] < counts[:, None])        # [B, S]
    init = (jnp.zeros(b, bool), jnp.zeros(b, jnp.int32),
            jnp.zeros(b, jnp.int32), jnp.zeros(b, jnp.int32),
            jnp.zeros(b, jnp.int32))
    (_, _, err, bits, uns), _ = jax.lax.scan(
        step, init, (jnp.moveaxis(errs, 1, 0), live.T))
    return err, bits, uns
