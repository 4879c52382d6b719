"""Batched soft-decision Viterbi decoder for the M17 K=5 code.

Reference: m17_viterbi_decode / m17_conv_new_metric (m17_conv.cpp:73-168).

Batched design: instead of one scalar trellis with a 1 MB path memory
(m17_conv.cpp:17), decode B channels at once with the 16 states as a
trailing vector axis.  The add-compare-select step is a static gather
over the state axis plus elementwise max -- across all channels in
lockstep -- rolled over trellis steps with `lax.scan`.  On a GPU the
same recursion runs as one Pallas kernel (fec/viterbi_pallas.py).
M17 frames are short (<= 244 steps) and zero-terminated, so the full
per-frame decision matrix is kept (244 x B x 16 bits) and traced back in
a second scan; no windowed traceback is needed.

Conventions:
  * soft bits: >0 => bit 1, <0 => bit 0, 0.0 => erasure (depunctured).
  * output bit t is the bit that *entered* the encoder at step t, so
    data = out[..., :n_data] and the 4 zero tail bits are at the end.
    (The reference's traceback emits the same sequence shifted one
    position later -- its callers index from bits[1]; see
    m17_conv.cpp:162-166 vs m17_rx_parse.cpp:97.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .conv import DIBIT0, DIBIT1, NUM_STATES, PREV0, PREV1

# Per-next-state sign masks for branch metrics: metric contribution of
# soft pair (m1, m2) for branch dibit d is s1*m1 + s2*m2 with s = +-1.
_S1_0 = np.where((DIBIT0 >> 1) & 1, 1.0, -1.0).astype(np.float32)
_S2_0 = np.where(DIBIT0 & 1, 1.0, -1.0).astype(np.float32)
_S1_1 = np.where((DIBIT1 >> 1) & 1, 1.0, -1.0).astype(np.float32)
_S2_1 = np.where(DIBIT1 & 1, 1.0, -1.0).astype(np.float32)


def viterbi_decode(soft: jnp.ndarray, return_metric: bool = False):
    """Decode [..., 2T] soft bits -> [..., T] hard bits.

    The implementation is chosen by the platform the computation is
    lowered for: on a CUDA GPU the Pallas Triton kernel
    (`viterbi_pallas.viterbi_decode_pallas`, bit-exact with the XLA
    formulation) runs as one launch per decode; on every other
    platform the XLA `lax.scan` formulation below runs.
    """
    from .viterbi_pallas import viterbi_decode_pallas

    return jax.lax.platform_dependent(
        soft,
        cuda=lambda s: viterbi_decode_pallas(s, return_metric=return_metric),
        default=lambda s: viterbi_decode_xla(s, return_metric=return_metric))


@functools.partial(jax.jit, static_argnames=("return_metric",))
def viterbi_decode_xla(soft: jnp.ndarray, return_metric: bool = False):
    """XLA `lax.scan` formulation of the decoder.

    Terminated trellis: traceback starts from state 0 (the TX appends a
    4-zero tail, m17_conv.cpp:160) and the initial metrics pin the start
    to state 0 with a large negative bias elsewhere.  This makes the
    decoder exactly maximum-likelihood over the terminated codebook; the
    reference instead biases state 0 by only +1.0 (m17_conv.cpp:150-153),
    which can deviate from ML in deep noise.

    If return_metric, also returns the winning terminal path metric
    [...] (a per-channel decode-confidence measure the reference does
    not expose).
    """
    *batch, n2 = soft.shape
    t_steps = n2 // 2
    pairs = soft.reshape(*batch, t_steps, 2)
    m1 = pairs[..., 0]
    m2 = pairs[..., 1]
    # Branch metrics toward each next state via its two predecessors:
    # [..., T, 16] each.
    bm0 = m1[..., None] * _S1_0 + m2[..., None] * _S2_0
    bm1 = m1[..., None] * _S1_1 + m2[..., None] * _S2_1

    prev0 = jnp.asarray(PREV0)
    prev1 = jnp.asarray(PREV1)

    acm0 = jnp.full((*batch, NUM_STATES), -1.0e6, dtype=jnp.float32)
    acm0 = acm0.at[..., 0].set(0.0)

    def acs(acm, bms):
        b0, b1 = bms
        cand0 = jnp.take(acm, prev0, axis=-1) + b0
        cand1 = jnp.take(acm, prev1, axis=-1) + b1
        # Tie-break: the reference keeps the *second* predecessor on
        # equality (m17_conv.cpp:19 uses strict >).
        take0 = cand0 > cand1
        new = jnp.where(take0, cand0, cand1)
        return new, jnp.where(take0, 0, 1).astype(jnp.uint8)

    # scan over the time axis (moved to front)
    bm0_t = jnp.moveaxis(bm0, -2, 0)
    bm1_t = jnp.moveaxis(bm1, -2, 0)
    acm_final, decisions = jax.lax.scan(acs, acm0, (bm0_t, bm1_t))
    # decisions: [T, ..., 16]

    def traceback(state, dec_t):
        bit = (state >> 3).astype(jnp.uint8)
        d = jnp.take_along_axis(dec_t, state[..., None], axis=-1)[..., 0]
        prev = ((state & 7) << 1) | d.astype(jnp.int32)
        return prev, bit

    state0 = jnp.zeros(tuple(batch), dtype=jnp.int32)
    _, bits_rev = jax.lax.scan(traceback, state0, decisions, reverse=True)
    bits = jnp.moveaxis(bits_rev, 0, -1)  # [..., T]

    if return_metric:
        return bits, acm_final[..., 0]
    return bits
