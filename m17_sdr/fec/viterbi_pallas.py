"""Pallas kernel (Triton route) for the batched K=5 soft Viterbi decoder.

Reference behavior: m17_viterbi_decode / m17_conv_new_metric
(m17_conv.cpp:73-168).  Bit-exact against `viterbi.viterbi_decode_xla`
(the XLA `lax.scan` formulation) -- same trellis tables, same strict->
tie-break, same terminated-trellis init, same f32 additions in the same
order, so the terminal metrics agree too.

Why a kernel: the XLA formulation is a forward scan plus a reverse
traceback scan of 148-244 steps whose bodies are tiny `[N, 16]`
elementwise ops; on a GPU every scan trip is a loop iteration with its
own launches.  Here the whole trellis runs inside one launch:

  * one thread per trellis: the grid runs over blocks of `_BLOCK`
    trellises, and the 16 path metrics are a loop carry of 16 `[BLK]`
    register vectors.  The add-compare-select butterfly is unrolled
    over the 16 next states at trace time with static predecessor
    indices (PREV0/PREV1 are compile-time tables), so there is no
    gather;
  * inputs are laid out `[T, N]` so each step's load is coalesced;
  * per-step survivor decisions are packed into one int32 word per
    trellis (bit v = predecessor choice of next state v) and written to
    an extra `[T, N]` output, which stays in L2;
  * the traceback is a second loop in the same kernel that re-reads its
    own trellis's words (same thread, same layout) and emits the bits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .conv import DIBIT0, DIBIT1, NUM_STATES, PREV0, PREV1

_BLOCK = 128           # trellises per program: one per thread of 4 warps
_NUM_WARPS = 4
_NUM_STAGES = 1
_NEG = -1.0e6


def _branch(dibit: int, pp, pm, mp, mm):
    """Branch metric for a dibit (g1 g2) from the 4 precomputed sign combos."""
    return {
        0b11: pp,   # +m1 +m2
        0b10: pm,   # +m1 -m2
        0b01: mp,   # -m1 +m2
        0b00: mm,   # -m1 -m2
    }[dibit]


def _viterbi_kernel(m1_ref, m2_ref, bits_ref, metric_ref, dec_ref):
    t_steps, blk = m1_ref.shape

    def fwd(t, acm):
        m1 = m1_ref[t, :]                     # [BLK]
        m2 = m2_ref[t, :]
        pp = m1 + m2
        pm = m1 - m2
        mp = -pm
        mm = -pp
        new = []
        word = jnp.zeros((blk,), jnp.int32)
        for v in range(NUM_STATES):
            b0 = _branch(int(DIBIT0[v]), pp, pm, mp, mm)
            b1 = _branch(int(DIBIT1[v]), pp, pm, mp, mm)
            cand0 = acm[int(PREV0[v])] + b0
            cand1 = acm[int(PREV1[v])] + b1
            # strict > keeps the second predecessor on ties
            # (m17_conv.cpp:19)
            take0 = cand0 > cand1
            new.append(jnp.where(take0, cand0, cand1))
            word = word | jnp.where(take0, 0, 1 << v)
        dec_ref[t, :] = word
        return tuple(new)

    # terminated-trellis init: state 0 at 0.0, the rest pinned far down
    acm0 = tuple(jnp.full((blk,), 0.0 if v == 0 else _NEG, jnp.float32)
                 for v in range(NUM_STATES))
    acm = jax.lax.fori_loop(0, t_steps, fwd, acm0)
    metric_ref[0, :] = acm[0]

    def bwd(i, state):
        t = t_steps - 1 - i
        word = dec_ref[t, :]
        d = jax.lax.shift_right_logical(word, state) & 1
        bits_ref[t, :] = state >> 3
        return ((state & 7) << 1) | d

    jax.lax.fori_loop(0, t_steps, bwd, jnp.zeros((blk,), jnp.int32))


@functools.partial(jax.jit, static_argnames=("return_metric", "interpret"))
def viterbi_decode_pallas(
    soft: jnp.ndarray,
    return_metric: bool = False,
    interpret: bool = False,
):
    """Decode [..., 2T] soft bits -> [..., T] hard bits with one kernel.

    Drop-in for `viterbi.viterbi_decode_xla`; same conventions (soft >0
    -> bit 1, 0.0 erasure; output bit t is the encoder input at step t).
    The trellis count is padded up to a multiple of the block; padded
    trellises decode zeros and are sliced off.  `interpret=True` runs
    the Pallas interpreter (CPU tests only).
    """
    *batch, n2 = soft.shape
    t_steps = n2 // 2
    n = int(np.prod(batch)) if batch else 1
    n_pad = -(-n // _BLOCK) * _BLOCK

    planes = jnp.moveaxis(soft.reshape(n, t_steps, 2), 0, -1)   # [T, 2, N]
    if n_pad != n:
        planes = jnp.pad(planes, ((0, 0), (0, 0), (0, n_pad - n)))
    m1 = planes[:, 0, :]                                        # [T, Npad]
    m2 = planes[:, 1, :]

    spec_tn = pl.BlockSpec((t_steps, _BLOCK), lambda i: (0, i))
    bits, metric, _ = pl.pallas_call(
        _viterbi_kernel,
        grid=(n_pad // _BLOCK,),
        in_specs=[spec_tn, spec_tn],
        out_specs=[spec_tn, pl.BlockSpec((1, _BLOCK), lambda i: (0, i)),
                   spec_tn],
        out_shape=[
            jax.ShapeDtypeStruct((t_steps, n_pad), jnp.int32),   # bits
            jax.ShapeDtypeStruct((1, n_pad), jnp.float32),       # metric
            jax.ShapeDtypeStruct((t_steps, n_pad), jnp.int32),   # decisions
        ],
        backend="triton",
        compiler_params=pltr.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
        interpret=interpret,
        name="viterbi_k5",
    )(m1, m2)

    out = jnp.moveaxis(bits[:, :n], -1, 0).astype(jnp.uint8)
    out = out.reshape(*batch, t_steps)
    if return_metric:
        return out, metric[0, :n].reshape(*batch)
    return out
