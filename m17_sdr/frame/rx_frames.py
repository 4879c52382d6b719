"""RX frame decoding: symbols -> soft bits -> decoded fields, batched.

Reference: m17_rx_parse.cpp + m17_dsp.cpp:35-95 (demap).  Each decoder
takes [B, ...] arrays for B (channel, frame) pairs and is fully
branchless; frame-type dispatch happens in the session layer by decoding
every type's fixed-shape path and selecting by mask (the trellis work is
dominated by the stream path, and batching beats branching).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..fec import viterbi
from ..spec import bits, crc, golay, interleave, puncture, whiten
from ..spec.constants import DEMAP_LSB_OFFSET, FRAME_SYMBOLS, SYNC_SYMBOLS


def demap_frame(symbols: jnp.ndarray) -> jnp.ndarray:
    """[B, 192] frame symbols -> [B, 368] soft bits.

    The 8 sync symbols provide the magnitude reference (their nominal
    levels are +-3 -> |.|*cor averages to 1 for +-1 levels... the
    reference normalizes so sync-symbol magnitude maps to 1.0 and then
    thresholds the LSB at 2/3); m17_dsp_demap_frame (m17_dsp.cpp:82-95)
    and m17_dsp_demap_symbol (m17_dsp.cpp:35-42).

    Soft-bit convention: >0 => 1, <0 => 0.
    msb = -m (negative symbols carry msb=1); lsb = |m| - 0.6666.
    """
    sync_mag = jnp.mean(jnp.abs(symbols[..., :SYNC_SYMBOLS]), axis=-1)
    cor = 1.0 / jnp.maximum(sync_mag, 1e-9)
    m = symbols[..., SYNC_SYMBOLS:] * cor[..., None]       # [B, 184]
    soft = jnp.stack([-m, jnp.abs(m) - DEMAP_LSB_OFFSET], axis=-1)
    return soft.reshape(*symbols.shape[:-1], 2 * (FRAME_SYMBOLS - SYNC_SYMBOLS))


def _unwrap(soft368: jnp.ndarray) -> jnp.ndarray:
    """de-correlate + de-interleave (m17_rx_parse.cpp:90-91 etc.)."""
    return interleave.deinterleave(whiten.whiten_soft(soft368))


class LsfDecode(NamedTuple):
    lsf_bytes: jnp.ndarray   # [B, 30]
    crc_ok: jnp.ndarray      # [B] bool
    metric: jnp.ndarray      # [B] Viterbi confidence


def decode_lsf(soft368: jnp.ndarray) -> LsfDecode:
    """Link-setup frame decode (decode_link_frame,
    m17_rx_parse.cpp:86-101).

    Note: the reference validates the CRC of the wrong buffer there (it
    checks `m_packet`, line 98); we check the decoded LSF itself.
    """
    de = _unwrap(soft368)
    full = puncture.depuncture(de, "p1", 488)
    decoded, metric = viterbi.viterbi_decode(full, return_metric=True)
    lsf = bits.bits_to_bytes(decoded[..., :240])           # [B, 30]
    ok = crc.crc16_fixed(lsf) == 0
    return LsfDecode(lsf_bytes=lsf, crc_ok=ok, metric=metric)


class StreamDecode(NamedTuple):
    lich_chunk: jnp.ndarray  # [B, 5] LSF fragment bytes
    lich_seq: jnp.ndarray    # [B] mod-6 chunk index
    golay_errors: jnp.ndarray  # [B] summed over the 4 codewords
    fn: jnp.ndarray          # [B] 16-bit frame number
    payload: jnp.ndarray     # [B, 16] voice bytes
    metric: jnp.ndarray      # [B]
    quality: jnp.ndarray     # [B] metric / soft-input energy in [0, 1]


def decode_stream(soft368: jnp.ndarray) -> StreamDecode:
    """Stream frame decode (decode_stream_frame, m17_rx_parse.cpp:105-160).

    ``quality`` is the Viterbi terminal path metric normalized by the
    total soft-bit magnitude of the coded payload: the winning path's
    correlation can at most equal the input energy (every soft bit
    agreeing in sign), so a confident decode sits near 1.0 while a
    frame whose tail was garbled (e.g. by a mid-frame timing slip)
    drops sharply -- the disagreement is concentrated exactly where
    the symbols no longer carry the code.  The session layer uses it
    to gate voice routing (the reference exposes no such measure and
    delivers garbled frames to the vocoder, m17_rx_frame.cpp:141-153).
    """
    de = _unwrap(soft368)
    b = de.shape[0]

    # LICH: 4 Golay words from the first 96 soft bits
    gw = bits.hard_decision_word(de[..., :96].reshape(b, 4, 24))   # [B,4]
    data12, nerr = golay.golay_decode(gw)
    lich6 = bits.u12x4_to_bytes(data12)                    # [B, 6]
    lich_seq = (lich6[..., 5] >> 5).astype(jnp.int32)      # m17_rx_parse.cpp:73

    # Payload: depuncture P2 -> Viterbi
    full = puncture.depuncture(de[..., 96:], "p2", 296)
    decoded, metric = viterbi.viterbi_decode(full, return_metric=True)
    energy = jnp.sum(jnp.abs(full), axis=-1)
    pld = bits.bits_to_bytes(decoded[..., :144])           # [B, 18]
    fn = bits.bytes_to_word_device(pld[..., :2])
    return StreamDecode(
        lich_chunk=lich6[..., :5],
        lich_seq=lich_seq,
        golay_errors=jnp.sum(nerr, axis=-1),
        fn=fn,
        payload=pld[..., 2:18],
        metric=metric,
        quality=metric / jnp.maximum(energy, 1e-9),
    )


class PacketDecode(NamedTuple):
    data: jnp.ndarray        # [B, 25] chunk bytes
    eof: jnp.ndarray         # [B] bool
    fn: jnp.ndarray          # [B] frame number / final length
    metric: jnp.ndarray


def decode_packet(soft368: jnp.ndarray) -> PacketDecode:
    """Packet frame decode (decode_packet_frame, m17_rx_parse.cpp:161-177)."""
    de = _unwrap(soft368)
    full = puncture.depuncture(de, "p3", 420)
    decoded, metric = viterbi.viterbi_decode(full, return_metric=True)
    by = bits.bits_to_bytes(decoded[..., :208])            # [B, 26]
    meta = by[..., 25].astype(jnp.int32)
    return PacketDecode(
        data=by[..., :25],
        eof=(meta >> 7) == 1,
        fn=(meta >> 2) & 0x1F,
        metric=metric,
    )


class BertDecode(NamedTuple):
    bits: jnp.ndarray        # [B, 197] decoded PRBS bits
    metric: jnp.ndarray


def decode_bert(soft368: jnp.ndarray) -> BertDecode:
    """BERT frame decode.

    The reference left this as an empty stub (m17_rx_parse.cpp:178-180);
    this is the finished inverse of build_bert_frame: the 368 received
    soft bits are the first 368 of a 369-bit P2-punctured stream whose
    coded length was truncated from 410 to 402, so the missing positions
    are treated as erasures.
    """
    de = _unwrap(soft368)
    padded369 = jnp.pad(de, [(0, 0)] * (de.ndim - 1) + [(0, 1)])
    full402 = puncture.depuncture(padded369, "p2", 402)
    full410 = jnp.pad(full402, [(0, 0)] * (de.ndim - 1) + [(0, 8)])
    decoded, metric = viterbi.viterbi_decode(full410, return_metric=True)
    return BertDecode(bits=decoded[..., :197], metric=metric)


def parse_lsf_fields(lsf_bytes: jnp.ndarray):
    """Split [B, 30] LSF bytes -> (dst [B,6], src [B,6], type [B], meta [B,14]).

    Reference: parse_lsf (m17_rx_parse.cpp:52-70).
    """
    dst = lsf_bytes[..., 0:6]
    src = lsf_bytes[..., 6:12]
    type_word = bits.bytes_to_word_device(lsf_bytes[..., 12:14])
    meta = lsf_bytes[..., 14:28]
    return dst, src, type_word, meta
