"""Frame-level round trips: TX build -> symbols -> demap -> RX decode.

These bypass the analog DSP (the direct digital path): dibits map
straight to their symbol levels, optionally with noise/gain applied,
then the frame decoders run.  Equivalent in spirit to the reference's
__TEST__ loopback minus timing recovery (m17_test.cpp).
"""

import jax
import jax.numpy as jnp
import numpy as np

from m17_sdr.frame import rx_frames, tx_frames
from m17_sdr.spec import bits as bitpack
from m17_sdr.spec import callsign, crc, prbs
from m17_sdr.spec.constants import DIBIT_TO_SYMBOL
from m17_sdr.spec.typefield import M17Type

B = 4


def _symbols(dibits, gain=1.0):
    return jnp.asarray(DIBIT_TO_SYMBOL)[dibits] * gain


def _mk_lsf(b=B):
    dst = jnp.asarray(
        np.tile(np.frombuffer(b"\x00\x00\x01\x02\x03\x04", np.uint8), (b, 1)))
    src_word = callsign.encode_callsign("G4GUO")
    src = jnp.asarray(np.tile(bitpack.word_to_bytes(src_word, 6), (b, 1)))
    tw = jnp.full((b,), M17Type().pack(), dtype=jnp.uint32)
    meta = jnp.zeros((b, 14), dtype=jnp.uint8)
    return tx_frames.build_lsf_bytes(dst, src, tw, meta)


class TestLsfRoundtrip:
    def test_clean(self):
        lsf = _mk_lsf()
        frame = tx_frames.build_link_setup_frame(lsf)
        assert frame.shape == (B, 192)
        soft = rx_frames.demap_frame(_symbols(frame, gain=0.31))
        dec = rx_frames.decode_lsf(soft)
        assert np.all(np.asarray(dec.crc_ok))
        assert np.array_equal(np.asarray(dec.lsf_bytes), np.asarray(lsf))
        dst, src, tw, meta = rx_frames.parse_lsf_fields(dec.lsf_bytes)
        assert callsign.decode_callsign(
            int(bitpack.bytes_to_word(np.asarray(src[0])))).strip() == "G4GUO"

    def test_noisy(self):
        lsf = _mk_lsf()
        frame = tx_frames.build_link_setup_frame(lsf)
        key = jax.random.PRNGKey(0)
        syms = _symbols(frame) + jax.random.normal(key, (B, 192)) * 0.45
        dec = rx_frames.decode_lsf(rx_frames.demap_frame(syms))
        assert np.all(np.asarray(dec.crc_ok))
        assert np.array_equal(np.asarray(dec.lsf_bytes), np.asarray(lsf))


class TestStreamRoundtrip:
    def test_all_lich_chunks(self):
        lsf = _mk_lsf(6)
        rng = np.random.default_rng(1)
        payload = jnp.asarray(rng.integers(0, 256, (6, 16), dtype=np.uint8))
        count = jnp.arange(6)
        fn = jnp.arange(6).astype(jnp.uint32) + 100
        frame = tx_frames.build_stream_frame(lsf, count, fn, payload)
        dec = rx_frames.decode_stream(rx_frames.demap_frame(_symbols(frame)))
        assert np.all(np.asarray(dec.golay_errors) == 0)
        assert np.array_equal(np.asarray(dec.fn), np.asarray(fn))
        assert np.array_equal(np.asarray(dec.payload), np.asarray(payload))
        assert np.array_equal(np.asarray(dec.lich_seq), np.arange(6))
        # chunks reassemble the LSF
        reassembled = np.asarray(dec.lich_chunk).reshape(30)
        assert np.array_equal(reassembled, np.asarray(lsf[0]))

    def test_with_noise(self):
        lsf = _mk_lsf()
        rng = np.random.default_rng(2)
        payload = jnp.asarray(rng.integers(0, 256, (B, 16), dtype=np.uint8))
        frame = tx_frames.build_stream_frame(
            lsf, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.uint32), payload)
        key = jax.random.PRNGKey(3)
        syms = _symbols(frame, 0.5) + jax.random.normal(key, (B, 192)) * 0.2
        dec = rx_frames.decode_stream(rx_frames.demap_frame(syms))
        assert np.array_equal(np.asarray(dec.payload), np.asarray(payload))
        # noise may flip a few Golay bits; they must stay correctable and
        # the corrected chunk must still match the LSF
        assert np.array_equal(np.asarray(dec.lich_chunk),
                              np.asarray(lsf[:, :5]))


class TestPacketRoundtrip:
    def test_clean(self):
        rng = np.random.default_rng(4)
        data = jnp.asarray(rng.integers(0, 256, (B, 25), dtype=np.uint8))
        eof = jnp.array([False, True, False, True])
        nf = jnp.array([0, 25, 3, 7])
        frame = tx_frames.build_packet_frame(data, eof, nf)
        dec = rx_frames.decode_packet(rx_frames.demap_frame(_symbols(frame)))
        assert np.array_equal(np.asarray(dec.data), np.asarray(data))
        assert np.array_equal(np.asarray(dec.eof), np.asarray(eof))
        assert np.array_equal(np.asarray(dec.fn), np.asarray(nf))


class TestBertRoundtrip:
    def test_clean_and_advancing(self):
        start = jnp.array([0, 197, 394])
        frame = tx_frames.build_bert_frame(start)
        dec = rx_frames.decode_bert(rx_frames.demap_frame(_symbols(frame)))
        errors, shift = prbs.align_and_count_errors(dec.bits)
        assert errors.tolist() == [0, 0, 0]
        assert shift.tolist() == [0, 197, 394 % 511]

    def test_noisy_ber(self):
        frame = tx_frames.build_bert_frame(jnp.zeros(8, jnp.int32))
        key = jax.random.PRNGKey(5)
        syms = _symbols(frame) + jax.random.normal(key, (8, 192)) * 0.5
        dec = rx_frames.decode_bert(rx_frames.demap_frame(syms))
        errors, _ = prbs.align_and_count_errors(dec.bits)
        # moderate noise: the K=5 code should fully correct
        assert np.all(np.asarray(errors) == 0)


class TestFixedPatterns:
    def test_preamble_and_eot_shapes(self):
        assert tx_frames.preamble_frame(2).shape == (2, 192)
        assert tx_frames.eot_frame(2).shape == (2, 192)

    def test_sync_symbols_are_pm3(self):
        """All four sync words use only the +-3 symbol levels, which is
        what makes the demap magnitude reference work
        (m17_dsp.cpp:82-95)."""
        lsf = _mk_lsf(1)
        for builder in [
            lambda: tx_frames.build_link_setup_frame(lsf),
            lambda: tx_frames.build_stream_frame(
                lsf, jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.uint32),
                jnp.zeros((1, 16), jnp.uint8)),
        ]:
            frame = np.asarray(builder())
            sync_syms = DIBIT_TO_SYMBOL[frame[0, :8]]
            assert np.all(np.abs(sync_syms) == 3.0)
