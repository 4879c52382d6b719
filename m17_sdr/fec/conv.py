"""M17 convolutional code: K=5, rate 1/2, 16 states.

Reference: m17_conv.cpp.  The encoder shift register takes the new bit
at position 4 and shifts right (lines 33-49), so the state transition is

    state' = (state >> 1) | (bit << 3)

and the generator taps (from the clut construction, lines 24-29) are
    G1 = sr4 ^ sr1 ^ sr0   (0b10011)
    G2 = sr4 ^ sr3 ^ sr2 ^ sr0 (0b11101)

Batched design: the encoder output is *linear over GF(2)* in the input
bits, so a whole frame encodes as one bit-matrix product -- no scan, no
shift register, batched over channels.  The trellis tables
below are shared with the Viterbi decoder.

Output-length convention: encoding n input bits appends a 4-zero tail
and yields 2*(n+4) coded bits, exactly like m17_conv_encode_8/1.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

NUM_STATES = 16
TAIL_BITS = 4
G1_TAPS = 0b10011  # sr4, sr1, sr0
G2_TAPS = 0b11101  # sr4, sr3, sr2, sr0


def _parity5(x: int) -> int:
    return bin(x & 0x1F).count("1") & 1


# clut equivalent: for the 5-bit register value (new bit at bit 4),
# the two coded output bits (m17_conv.cpp:24-29).
CLUT = np.array(
    [[_parity5(sr & G1_TAPS), _parity5(sr & G2_TAPS)] for sr in range(32)],
    dtype=np.int8,
)


def _trellis_tables():
    """Per next-state tables for the radix-2 butterflies.

    For next state v: input bit b = v >> 3; predecessors are
    w0 = (v & 7) << 1 and w1 = w0 + 1; branch dibit for w -> v is
    CLUT[w | b << 4].
    """
    prev0 = np.zeros(NUM_STATES, dtype=np.int32)
    prev1 = np.zeros(NUM_STATES, dtype=np.int32)
    dibit0 = np.zeros(NUM_STATES, dtype=np.int32)
    dibit1 = np.zeros(NUM_STATES, dtype=np.int32)
    for v in range(NUM_STATES):
        b = v >> 3
        w0 = (v & 7) << 1
        w1 = w0 + 1
        prev0[v], prev1[v] = w0, w1
        dibit0[v] = (CLUT[w0 | (b << 4)][0] << 1) | CLUT[w0 | (b << 4)][1]
        dibit1[v] = (CLUT[w1 | (b << 4)][0] << 1) | CLUT[w1 | (b << 4)][1]
    return prev0, prev1, dibit0, dibit1


PREV0, PREV1, DIBIT0, DIBIT1 = _trellis_tables()


@functools.lru_cache(maxsize=None)
def _encode_matrix(nbits: int) -> np.ndarray:
    """[nbits, 2*(nbits+4)] GF(2) generator matrix for a terminated frame.

    Coded bit 2t (G1 stream) depends on input bits {t, t-3, t-4};
    coded bit 2t+1 (G2 stream) on {t, t-1, t-2, t-4} -- the taps of
    G1/G2 applied to the bit history (newest bit has lag 0).
    """
    total = nbits + TAIL_BITS
    m = np.zeros((nbits, 2 * total), dtype=np.int8)
    # lag l contributes if tap (4 - l) ... derive directly: at step t the
    # register holds input bits t, t-1, t-2, t-3, t-4 at positions
    # 4, 3, 2, 1, 0 respectively.
    g1_lags = [4 - p for p in range(5) if (G1_TAPS >> p) & 1]  # positions
    g2_lags = [4 - p for p in range(5) if (G2_TAPS >> p) & 1]
    for t in range(total):
        for lag in g1_lags:
            i = t - lag
            if 0 <= i < nbits:
                m[i, 2 * t] ^= 1
        for lag in g2_lags:
            i = t - lag
            if 0 <= i < nbits:
                m[i, 2 * t + 1] ^= 1
    return m


def conv_encode_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """Encode [..., N] hard bits -> [..., 2*(N+4)] coded bits.

    One int matmul + mod 2 over the whole frame (reference does a scalar
    shift-register loop, m17_conv_encode_1 at m17_conv.cpp:33-49).
    """
    n = bits.shape[-1]
    m = jnp.asarray(_encode_matrix(n), dtype=jnp.int32)
    out = (bits.astype(jnp.int32) @ m) % 2
    return out.astype(jnp.uint8)


def conv_encode_bytes(data: jnp.ndarray) -> jnp.ndarray:
    """Encode [..., B] bytes (MSB first) -> [..., 2*(8B+4)] coded bits.

    Reference: m17_conv_encode_8 (m17_conv.cpp:53-71).
    """
    from ..spec import bits as bitpack

    return conv_encode_bits(bitpack.bytes_to_bits(data))
