"""Sync-word correlation and lock gating, batched.

Reference: m17_rx_frame.cpp:22-103 (find_variance, m17_sync_check,
m17_unlocked_sync_check, m17_locked_sync_check).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..spec.constants import (
    FT_BERT,
    FT_LINK,
    LOCKED_MAX_VARIANCE,
    LOCKED_MAX_VOTES,
    SYNC_PATTERNS,
    UNLOCKED_MAX_VARIANCE,
    UNLOCKED_MAX_VOTES,
)

HIGHEST = jax.lax.Precision.HIGHEST


class SyncCheck(NamedTuple):
    ftype: jnp.ndarray     # [B] best-matching frame type (0..5)
    votes: jnp.ndarray     # [B] count of disagreeing symbols
    variance: jnp.ndarray  # [B] magnitude spread of the 8 sync symbols


def sync_check(vect: jnp.ndarray) -> SyncCheck:
    """Correlate [B, 8] symbols against the 6 sync patterns.

    Mirrors m17_sync_check (m17_rx_frame.cpp:47-81): the winning type is
    the largest strictly-positive correlation (all-negative defaults to
    type 0); votes counts symbols whose sign disagrees with the winner;
    variance is (max|s|-min|s|)/max|s| with NaN scrubbed to 1.

    Gather-free on purpose: a per-lane gather (`pats[ftype]`) inside the
    receiver scan costs more than a tiny matmul.  The disagreement count for
    *all* six patterns comes out of one sign matmul -- for +-1 patterns,
    sign(vect) @ pats.T = (#agree - #disagree) over the nonzero symbols,
    so votes_p = (#nonzero - that) / 2 -- and the winner's column is
    picked with a one-hot mask instead of an index.
    """
    # HIGHEST: a float32 product may otherwise run in TF32 on a GPU, and
    # the correlations feed threshold decisions (sync gates, argmax)
    pats = jnp.asarray(SYNC_PATTERNS)                     # [6, 8]
    sums = jnp.matmul(vect, pats.T, precision=HIGHEST)    # [B, 6]
    best = jnp.argmax(sums, axis=-1)
    ftype = jnp.where(jnp.max(sums, axis=-1) > 0, best, 0).astype(jnp.int32)

    s = jnp.sign(vect)                                    # [B, 8]
    agree_minus_disagree = jnp.matmul(s, pats.T, precision=HIGHEST)
    nnz = jnp.sum(jnp.abs(s), axis=-1, keepdims=True)     # [B, 1]
    votes_all = (nnz - agree_minus_disagree) * 0.5        # [B, 6], integral
    onehot = jnp.arange(pats.shape[0])[None, :] == ftype[:, None]
    votes = jnp.sum(jnp.where(onehot, votes_all, 0.0), axis=-1).astype(jnp.int32)

    mags = jnp.abs(vect)
    mmax = jnp.max(mags, axis=-1)
    mmin = jnp.min(mags, axis=-1)
    variance = jnp.where(mmax > 0, (mmax - mmin) / jnp.maximum(mmax, 1e-30), 1.0)
    return SyncCheck(ftype=ftype, votes=votes, variance=variance)


def _is_payload_type(ftype: jnp.ndarray) -> jnp.ndarray:
    # types 1..4: link/stream/packet/bert (m17_rx_frame.cpp:86, 97)
    return (ftype >= FT_LINK) & (ftype <= FT_BERT)


def unlocked_pass(s: SyncCheck) -> jnp.ndarray:
    """Acquisition gate (m17_unlocked_sync_check, m17_rx_frame.cpp:82-92)."""
    return (
        (s.votes <= UNLOCKED_MAX_VOTES)
        & _is_payload_type(s.ftype)
        & (s.variance < UNLOCKED_MAX_VARIANCE)
    )


def locked_pass(s: SyncCheck) -> jnp.ndarray:
    """Tracking gate (m17_locked_sync_check, m17_rx_frame.cpp:93-103)."""
    return (
        (s.votes <= LOCKED_MAX_VOTES)
        & _is_payload_type(s.ftype)
        & (s.variance < LOCKED_MAX_VARIANCE)
    )
