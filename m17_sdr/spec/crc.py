"""M17 CRC-16 (poly 0x5935, init 0xFFFF, no reflection, no final xor).

Reference: m17_crc.cpp:4-35 (byte-table driven scalar loop).

Batched design: for the fixed message lengths used on the hot path
(30-byte LSF, 52/54-byte net frames) CRC is an *affine map over GF(2)*:

    crc_bits(msg) = (msg_bits @ A) xor crc_bits(0)

so a whole batch of messages reduces to one matmul + parity.  An
arbitrary-length batched scan version is provided for the packet path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import bits

CRC_POLY = 0x5935
CRC_INIT = 0xFFFF


def _crc_numpy(data: np.ndarray, init: int = CRC_INIT) -> int:
    """Scalar reference model used only to build tables (not on hot path)."""
    crc = init
    for byte in data.astype(np.uint32):
        crc ^= int(byte) << 8
        for _ in range(8):
            crc = ((crc << 1) ^ CRC_POLY if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


def _build_byte_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        tab[i] = _crc_numpy(np.array([i], dtype=np.uint8), init=0)
    return tab


CRC_TABLE = _build_byte_table()


@functools.lru_cache(maxsize=None)
def _affine(nbytes: int) -> tuple[np.ndarray, np.ndarray]:
    """GF(2) affine form of the CRC for a fixed message length.

    Returns (A, c): A is [8*nbytes, 16] over {0,1}; c is the 16-bit CRC of
    the all-zero message (carries the 0xFFFF init through the length).
    """
    zero = np.zeros(nbytes, dtype=np.uint8)
    c_word = _crc_numpy(zero)
    a = np.zeros((8 * nbytes, 16), dtype=np.int8)
    for i in range(8 * nbytes):
        msg = zero.copy()
        msg[i // 8] = 0x80 >> (i % 8)
        # xor out the constant to isolate the linear part
        w = _crc_numpy(msg) ^ c_word
        a[i] = [(w >> (15 - b)) & 1 for b in range(16)]
    c = np.array([(c_word >> (15 - b)) & 1 for b in range(16)], dtype=np.int8)
    return a, c


def crc16_fixed(data: jnp.ndarray) -> jnp.ndarray:
    """CRC-16 of [..., N] byte messages with static N, as one matmul.

    Returns the CRC as a uint32 word per message.  A valid message with
    its CRC appended yields 0 (m17_rx_parse.cpp:42, 79, 98, 148).
    """
    n = data.shape[-1]
    a, c = _affine(n)
    msg_bits = bits.bytes_to_bits(data).astype(jnp.float32)
    # Parity of the bit-matrix product: matmul then mod 2.  Exact at
    # any matmul precision, TF32 included: the operands are 0/1 (exact
    # in every float format) and the f32 sums stay <= 8*N < 2^24.
    crc_bits = (msg_bits @ jnp.asarray(a, dtype=jnp.float32)
                ).astype(jnp.int32) % 2
    crc_bits = jnp.bitwise_xor(crc_bits, jnp.asarray(c, dtype=jnp.int32))
    shifts = np.arange(15, -1, -1, dtype=np.uint32)
    return jnp.sum(crc_bits.astype(jnp.uint32) << shifts, axis=-1)


def crc16_scan(data: jnp.ndarray) -> jnp.ndarray:
    """CRC-16 over [..., N] bytes via a batched scan (any static N).

    Mirrors the byte-table loop (m17_crc.cpp:26-35) with the table lookup
    as a vectorized gather; used where the affine form would need a fresh
    matrix per length (packet reassembly).
    """
    table = jnp.asarray(CRC_TABLE, dtype=jnp.uint32)
    x = data.astype(jnp.uint32)

    def step(crc, byte):
        pos = ((crc >> 8) ^ byte) & 0xFF
        crc = ((crc << 8) ^ table[pos]) & 0xFFFF
        return crc, None

    init = jnp.full(x.shape[:-1], CRC_INIT, dtype=jnp.uint32)
    crc, _ = jax.lax.scan(step, init, jnp.moveaxis(x, -1, 0))
    return crc


def crc16_append(data: jnp.ndarray) -> jnp.ndarray:
    """Append the big-endian CRC to [..., N] byte messages -> [..., N+2]."""
    crc = crc16_fixed(data)
    hi = (crc >> 8).astype(jnp.uint8)[..., None]
    lo = (crc & 0xFF).astype(jnp.uint8)[..., None]
    return jnp.concatenate([data, hi, lo], axis=-1)
