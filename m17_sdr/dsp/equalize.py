"""Batched square-root Kalman (RLS) adaptive equalizer.

Reference: m17_equalize.cpp -- a 5-tap fractionally-spaced (2 samples
per symbol) adaptive equalizer whose gain vector comes from a Bierman
UD-factorised square-root Kalman recursion (eq_k_calculate,
m17_equalize.cpp:40-102), trained either on known symbols
(eq_train_known, 163-180) or decision-directed with a 4FSK slicer at
+-0.66 thresholds (eq_train_unknown, 185-212).  The reference keeps it
dormant (never called); here it is a first-class, fully batched stage.

Batched design: the KN=5 tap recursion is tiny and inherently
sequential *within* a symbol, so each inner loop is unrolled statically
(KN is a compile-time constant) into vector ops over the channel batch,
and the symbol loop is a `jax.lax.scan` with the whole filter state
(coefficients, UD factors, sample line) as the carry.  4096 channels
adapt in lockstep; there is no per-channel control flow.

Constants q (process noise) = 0.08 and E (measurement floor) = 0.01
follow eq_open (m17_equalize.cpp:217-222); d initialises to 0.1
(eq_k_reset_ud, m17_equalize.cpp:23-35).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

KN = 5          # taps (m17_equalize.cpp:3)
Q = 0.08        # m_q (m17_equalize.cpp:219)
E = 0.01        # m_E (m17_equalize.cpp:220)
D0 = 0.1        # initial d (m17_equalize.cpp:33)
HIGHEST = jax.lax.Precision.HIGHEST


class EqState(NamedTuple):
    """Per-channel equalizer state (the statics of m17_equalize.cpp)."""

    c: jnp.ndarray        # [B, KN] filter coefficients
    u: jnp.ndarray        # [B, KN, KN] strictly-upper UD factor (diag = 1 implicit)
    d: jnp.ndarray        # [B, KN] diagonal of the UD factor
    samples: jnp.ndarray  # [B, KN] delay line, 2 samples/symbol
    level: jnp.ndarray    # [B] running |symbol| estimate (stage AGC)

    @staticmethod
    def init(batch: int) -> "EqState":
        return EqState(
            c=jnp.zeros((batch, KN), jnp.float32),
            u=jnp.zeros((batch, KN, KN), jnp.float32),
            d=jnp.full((batch, KN), D0, jnp.float32),
            samples=jnp.zeros((batch, KN), jnp.float32),
            level=jnp.zeros((batch,), jnp.float32),
        )

    @staticmethod
    def init_identity(batch: int) -> "EqState":
        """Centre-tap-1 start: the stage passes the signal through
        unchanged until adaptation refines it -- the right cold start
        for an in-pipeline stage (decisions are meaningful from the
        first symbol, unlike the all-zero start)."""
        return EqState.init(batch)._replace(
            c=jnp.zeros((batch, KN), jnp.float32).at[:, KN // 2].set(1.0))

    def restart(self) -> "EqState":
        """Reset the UD factors but keep the converged taps
        (eq_restart, m17_equalize.cpp:141-144)."""
        return self._replace(
            u=jnp.zeros_like(self.u), d=jnp.full_like(self.d, D0))


def slicer(sym: jnp.ndarray) -> jnp.ndarray:
    """4FSK decision at normalized symbol amplitudes +-1/3, +-1
    (eq_train_unknown, m17_equalize.cpp:193-204)."""
    mag = jnp.where(jnp.abs(sym) >= 0.66, 1.0, 0.333)
    return jnp.where(sym > 0, mag, -mag).astype(jnp.float32)


def _kalman_gain(x, u, d):
    """One UD-factorised gain update, batched over channels.

    Returns (g [B,KN], y [B], new_u, new_d) -- the reference's
    eq_k_calculate (m17_equalize.cpp:40-102) with its j/i loops unrolled
    over the static KN.
    """
    # f = U^T x (U unit upper triangular; 6.2-6.3)
    f = [x[:, 0]]
    for j in range(1, KN):
        fj = x[:, j]
        for i in range(j):
            fj = fj + u[:, i, j] * x[:, i]
        f.append(fj)

    g = [d[:, j] * f[j] for j in range(KN)]                     # 6.4

    a = [E + g[0] * f[0]]                                       # 6.5
    for j in range(1, KN):
        a.append(a[j - 1] + g[j] * f[j])                        # 6.6

    hq = 1.0 + Q                                                # 6.7
    ht = a[KN - 1] * Q
    y = 1.0 / (a[0] + ht)                                       # 6.19

    new_d = [d[:, 0] * hq * (E + ht) * y]                       # 6.20
    new_u = u
    for j in range(1, KN):
        b = a[j - 1] + ht                                       # 6.21
        hj = -f[j] * y                                          # 6.11
        y = 1.0 / (a[j] + ht)                                   # 6.22
        new_d.append(d[:, j] * hq * b * y)                      # 6.13
        for i in range(j):
            b0 = new_u[:, i, j]
            new_u = new_u.at[:, i, j].add(hj * g[i])            # 6.15
            g[i] = g[i] + g[j] * b0                             # 6.16

    return jnp.stack(g, axis=-1), y, new_u, jnp.stack(new_d, axis=-1)


def _step(state: EqState, inputs):
    """One symbol: shift 2 samples in, equalize, train, adapt."""
    s2, known, use_known = inputs                # [B,2], [B], [B] bool
    samples = jnp.concatenate([state.samples[:, 2:], s2], axis=-1)
    sym = jnp.sum(samples * state.c, axis=-1)    # eq_equalize
    train = jnp.where(use_known, known, slicer(sym))
    err = train - sym
    g, y, u, d = _kalman_gain(samples, state.u, state.d)
    c = state.c + (err * y)[:, None] * g         # eq_k_update
    return EqState(c=c, u=u, d=d, samples=samples,
                   level=state.level), sym


@jax.jit
def equalize_train(
    samples2x: jnp.ndarray,
    state: EqState,
    train_symbols: jnp.ndarray | None = None,
    train_mask: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, EqState]:
    """Equalize [B, 2N] fractionally-spaced samples -> [B, N] symbols.

    Where `train_mask` is True the corresponding `train_symbols` column
    drives adaptation (known-symbol training, e.g. over sync words);
    elsewhere adaptation is decision-directed.  Both default to fully
    decision-directed operation.
    """
    b, n2 = samples2x.shape
    n = n2 // 2
    pairs = jnp.moveaxis(samples2x.reshape(b, n, 2), 1, 0)      # [N, B, 2]
    if train_symbols is None:
        known = jnp.zeros((n, b), jnp.float32)
        mask = jnp.zeros((n, b), bool)
    else:
        known = jnp.moveaxis(train_symbols.astype(jnp.float32), 1, 0)
        if train_mask is None:
            mask = jnp.ones((n, b), bool)
        else:
            mask = jnp.moveaxis(train_mask, 1, 0)
    state, syms = jax.lax.scan(_step, state, (pairs, known, mask))
    return jnp.moveaxis(syms, 0, 1), state


# ---------------------------------------------------------------------
# In-pipeline frame-domain equalizer.
#
# Placement: AFTER timing recovery, on the 192 timing-recovered symbols
# of each extracted frame, where decisions are reliable (pre-MF, the
# raw RRC stream's eye is partially closed even on a clean channel --
# decision-directed adaptation there provably corrupts clean signals).
# This is where the reference's dormant design points too: its
# eq_train_known trains on known symbols (m17_equalize.cpp:163-180),
# and the only known symbols exist post-framing (the sync word).
#
# Batched formulation: instead of a sequential per-symbol RLS, each
# frame contributes ONE batched block-least-squares tap update -- train
# targets are the 8 known sync symbols (+-3) plus 4FSK decisions for
# the 184 payload symbols; XtX is a [B, KN, KN] matmul and the solve is
# a batched 5x5 -- no scan.  The products run at HIGHEST precision: the
# equalized symbols feed 4FSK decisions and the normal equations are
# solved, so TF32's ~3 digits would move both.
# ---------------------------------------------------------------------

EQ_FRAME_MU = 0.5        # per-frame tap blend toward the LS solution
EQ_FRAME_LAMBDA = 1e-3   # Tikhonov regularizer on XtX


def _frame_windows(fr: jnp.ndarray) -> jnp.ndarray:
    """[B, N] frame symbols -> [B, N, KN] centred symbol-spaced windows
    (edge-clamped), so the equalizer output is delay-free."""
    pad = KN // 2
    x = jnp.pad(fr, ((0, 0), (pad, pad)), mode="edge")
    idx = jnp.arange(fr.shape[1])[:, None] + jnp.arange(KN)[None, :]
    return x[:, idx]


def slicer4(yn: jnp.ndarray) -> jnp.ndarray:
    """4FSK decision in +-1/+-3 units (threshold 2)."""
    mag = jnp.where(jnp.abs(yn) >= 2.0, 3.0, 1.0)
    return jnp.where(yn > 0, mag, -mag).astype(jnp.float32)


@jax.jit
def equalize_frames(
    frames: jnp.ndarray,
    c: jnp.ndarray,
    update: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Equalize [B, F, 192] extracted frame symbols with per-channel
    taps c [B, KN]; adapt once per frame where `update` [B, F] is True
    (the pipeline gates it by frame validity).  Returns (equalized
    frames, new taps).  Frame i is filtered with the taps as of its
    start (causal); its sync+decisions then update the taps for i+1.
    """
    b, f, n = frames.shape
    outs = []
    for i in range(f):
        x = _frame_windows(frames[:, i])                 # [B, N, KN]
        y = jnp.einsum("bnk,bk->bn", x, c, precision=HIGHEST)
        outs.append(y)
        # normalize on the sync word (nominal +-3) for the decisions
        scale = jnp.maximum(jnp.mean(jnp.abs(y[:, :8]), axis=-1) / 3.0,
                            1e-9)[:, None]
        tgt = slicer4(y / scale)
        tgt = tgt.at[:, :8].set(jnp.sign(y[:, :8] / scale) * 3.0)
        d = tgt * scale
        xtx = jnp.einsum("bnk,bnl->bkl", x, x, precision=HIGHEST) \
            + EQ_FRAME_LAMBDA * jnp.eye(KN)
        xtd = jnp.einsum("bnk,bn->bk", x, d, precision=HIGHEST)
        c_ls = jnp.linalg.solve(xtx, xtd[..., None])[..., 0]
        c_new = c + EQ_FRAME_MU * (c_ls - c)
        c_new = jnp.where(jnp.isfinite(c_new), c_new, c)
        c = jnp.where(update[:, i, None], c_new, c)
    return jnp.stack(outs, axis=1), c


@functools.partial(jax.jit, static_argnames=("taps",))
def isi_channel(symbols2x: jnp.ndarray, taps: tuple[float, ...]) -> jnp.ndarray:
    """Apply a static multipath (ISI) channel for equalizer testing:
    y[t] = sum_k taps[k] * x[t-k]."""
    k = len(taps)
    x = jnp.pad(symbols2x, ((0, 0), (k - 1, 0)))
    out = jnp.zeros_like(symbols2x)
    for i, t in enumerate(taps):
        out = out + t * x[:, k - 1 - i: x.shape[1] - i]
    return out
