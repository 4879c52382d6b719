"""Golay(24,12) encoder/decoder for the LICH.

Reference: m17_golay.cpp.  The generator rows (the M17 spec parity
matrix) are at m17_golay.cpp:11; encode is data<<12 | parity.

Batched design:
  * encode = GF(2) bit-matrix product (one int matmul + mod 2), batched;
    an int32 product of 0/1 operands is exact on every backend.
  * decode = syndrome via the same matmul, then a single gather into a
    4096-entry syndrome->(*error count*, *data-error vector*) table.

The syndrome table here enumerates all error patterns of weight <= 3
(2325 of them -- the code is perfect for 3 errors so their syndromes are
distinct); every other syndrome is flagged as 4+ errors.  The reference
additionally *guesses* a correction for some weight-4 patterns
(m17_golay.cpp:57-71); those corrections are wrong by construction and
callers only use the error count, so we report e=4 uncorrected instead.
"""

from __future__ import annotations

from itertools import combinations

import jax.numpy as jnp
import numpy as np

# Parity generator rows (m17_golay.cpp:11) -- one 12-bit parity row per
# data bit, MSB-first data indexing.
GOLAY_GTAB = np.array(
    [0xC75, 0x63B, 0xF68, 0x7B4, 0x3DA, 0xD99,
     0x6CD, 0x367, 0xDC6, 0xA97, 0x93E, 0x8EB],
    dtype=np.uint32,
)


def _word_to_bits(w: int, n: int) -> np.ndarray:
    return np.array([(w >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.int8)


# [12, 12] GF(2) parity matrix: parity_bits = data_bits @ P (mod 2)
_P = np.stack([_word_to_bits(int(g), 12) for g in GOLAY_GTAB])


def _parity_word(data: int) -> int:
    p = 0
    for n in range(12):
        if data & (0x800 >> n):
            p ^= int(GOLAY_GTAB[n])
    return p


def _build_syndrome_table() -> np.ndarray:
    """[4096] int32: (nerrors << 12) | data_error_vector, indexed by syndrome.

    Layout matches g_errtab (m17_golay.cpp:28, 49-72) for e <= 3.
    """
    tab = np.full(0x1000, 0x4000, dtype=np.int32)  # default: 4+ errors
    for weight in range(4):
        for pos in combinations(range(24), weight):
            word = 0
            for p in pos:
                word |= 1 << p
            data_err = word >> 12
            parity_err = word & 0xFFF
            syndrome = parity_err ^ _parity_word(data_err)
            tab[syndrome] = (weight << 12) | data_err
    return tab


SYNDROME_TABLE = _build_syndrome_table()
_P_JNP_SHIFTS = np.arange(11, -1, -1, dtype=np.uint32)


def _u12_to_bits(x: jnp.ndarray) -> jnp.ndarray:
    shifts = np.arange(11, -1, -1, dtype=np.int32)
    return ((x[..., None].astype(jnp.int32) >> shifts) & 1)


def golay_encode(data: jnp.ndarray) -> jnp.ndarray:
    """Encode [...] 12-bit data words -> [...] 24-bit codewords.

    Reference: m17_golay_encode (m17_golay.cpp:94-102).
    """
    dbits = _u12_to_bits(data)
    pbits = (dbits @ jnp.asarray(_P, dtype=jnp.int32)) % 2
    parity = jnp.sum(pbits.astype(jnp.uint32) << _P_JNP_SHIFTS, axis=-1)
    return (data.astype(jnp.uint32) << 12) | parity


def golay_decode(word: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode [...] 24-bit words -> (data [...] u12, nerrors [...] i32).

    nerrors == 4 means uncorrectable (4 or more bit errors).
    Reference: m_17_golay_decode (m17_golay.cpp:103-116).
    """
    word = word.astype(jnp.uint32)
    data = (word >> 12) & 0xFFF
    parity = word & 0xFFF
    dbits = _u12_to_bits(data)
    pbits = (dbits @ jnp.asarray(_P, dtype=jnp.int32)) % 2
    expect = jnp.sum(pbits.astype(jnp.uint32) << _P_JNP_SHIFTS, axis=-1)
    syndrome = parity ^ expect
    entry = jnp.take(jnp.asarray(SYNDROME_TABLE), syndrome.astype(jnp.int32))
    fixed = data ^ (entry.astype(jnp.uint32) & 0xFFF)
    nerr = (entry >> 12).astype(jnp.int32)
    return fixed, nerr
