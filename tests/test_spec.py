"""Unit tests for the protocol layer (KATs + properties).

Mirrors the self-tests the reference left commented out (CRC check value
m17_crc.cpp:40-49, Golay recovery m17_golay.cpp:74-89, callsign round
trip m17_bit_utils.cpp:256-262) and adds the property tests the
reference never had.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr.spec import bits, callsign, constants, crc, golay, interleave, prbs, puncture, typefield, whiten


class TestBits:
    def test_bytes_bits_roundtrip(self):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.integers(0, 256, size=(3, 7), dtype=np.uint8))
        assert jnp.array_equal(bits.bits_to_bytes(bits.bytes_to_bits(x)), x)

    def test_bit_order_msb_first(self):
        out = bits.bytes_to_bits(jnp.array([0x80, 0x01], dtype=jnp.uint8))
        assert out.tolist() == [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1]

    def test_dibits(self):
        b = jnp.array([1, 0, 1, 1, 0, 0, 0, 1], dtype=jnp.uint8)
        d = bits.bits_to_dibits(b)
        assert d.tolist() == [2, 3, 0, 1]
        assert jnp.array_equal(bits.dibits_to_bits(d), b)

    def test_bytes_to_dibits_matches_pack_16_to_2(self):
        # pack_16_to_2(0x55F7) -> MSB pair first (m17_bit_utils.cpp:75-85)
        d = bits.bytes_to_dibits(jnp.array([0x55, 0xF7], dtype=jnp.uint8))
        assert d.tolist() == [1, 1, 1, 1, 3, 3, 1, 3]

    def test_word_bytes_roundtrip(self):
        by = bits.word_to_bytes([0x123456789ABC], 6)
        assert by[0].tolist() == [0x12, 0x34, 0x56, 0x78, 0x9A, 0xBC]
        assert int(bits.bytes_to_word(by)[0]) == 0x123456789ABC

    def test_u12_partition_roundtrip(self):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.integers(0, 256, size=(4, 6), dtype=np.uint8))
        w = bits.bytes_to_u12x4(x)
        assert jnp.array_equal(bits.u12x4_to_bytes(w), x)

    def test_hard_decision(self):
        soft = jnp.array([0.5, -0.1, 0.0, -2.0], dtype=jnp.float32)
        # >= 0 decodes as 1 (m17_bit_utils.cpp:184)
        assert int(bits.hard_decision_word(soft)) == 0b1010


class TestCrc:
    def test_known_value_sequence_0_to_255(self):
        """The reference's own self-test message (m17_crc.cpp:40-49)."""
        msg = np.arange(256, dtype=np.uint8)
        expected = crc._crc_numpy(msg)
        got = int(crc.crc16_scan(jnp.asarray(msg)))
        assert got == expected

    def test_m17_spec_check_values(self):
        """Known-answer tests from the public M17 spec CRC section."""
        assert crc._crc_numpy(np.frombuffer(b"", dtype=np.uint8)) == 0xFFFF
        assert crc._crc_numpy(np.frombuffer(b"A", dtype=np.uint8)) == 0x206E
        assert crc._crc_numpy(np.frombuffer(b"123456789", dtype=np.uint8)) == 0x772B

    def test_fixed_matches_scan(self):
        rng = np.random.default_rng(2)
        msgs = jnp.asarray(rng.integers(0, 256, size=(16, 30), dtype=np.uint8))
        assert jnp.array_equal(crc.crc16_fixed(msgs), crc.crc16_scan(msgs))

    def test_append_validates_to_zero(self):
        rng = np.random.default_rng(3)
        msgs = jnp.asarray(rng.integers(0, 256, size=(8, 28), dtype=np.uint8))
        full = crc.crc16_append(msgs)
        assert full.shape == (8, 30)
        # a message with its CRC appended yields 0 (m17_rx_parse.cpp:79)
        assert jnp.all(crc.crc16_fixed(full) == 0)


class TestGolay:
    def test_encode_decode_clean(self):
        data = jnp.arange(4096, dtype=jnp.uint32)
        word = golay.golay_encode(data)
        out, nerr = golay.golay_decode(word)
        assert jnp.array_equal(out, data)
        assert jnp.all(nerr == 0)

    @pytest.mark.parametrize("weight", [1, 2, 3])
    def test_corrects_up_to_3_errors(self, weight):
        rng = np.random.default_rng(weight)
        data = jnp.asarray(rng.integers(0, 4096, size=256, dtype=np.uint32))
        word = golay.golay_encode(data)
        errs = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            pos = rng.choice(24, size=weight, replace=False)
            for p in pos:
                errs[i] |= np.uint32(1) << p
        out, nerr = golay.golay_decode(word ^ jnp.asarray(errs))
        assert jnp.array_equal(out, data)
        assert jnp.all(nerr == weight)

    def test_reference_example(self):
        """The commented-out self-test (m17_golay.cpp:74-89): data 0xABC,
        error 0x111000 (3 bit errors) must be repaired."""
        word = golay.golay_encode(jnp.array([0xABC], dtype=jnp.uint32))
        out, nerr = golay.golay_decode(word ^ 0x111000)
        assert int(out[0]) == 0xABC
        assert int(nerr[0]) == 3

    def test_four_errors_flagged(self):
        data = jnp.array([0x123], dtype=jnp.uint32)
        word = golay.golay_encode(data)
        out, nerr = golay.golay_decode(word ^ 0xF000)  # 4 errors in data
        assert int(nerr[0]) == 4


class TestInterleave:
    def test_involution(self):
        x = jnp.arange(368, dtype=jnp.int32)
        assert jnp.array_equal(interleave.interleave(interleave.interleave(x)), x)

    def test_is_permutation(self):
        p = np.sort(interleave.INTERLEAVE_PERM)
        assert np.array_equal(p, np.arange(368))

    def test_matches_reference_scatter(self):
        """out[pi(i)] = in[i] (m17_interleave.cpp:3-7)."""
        rng = np.random.default_rng(4)
        x = rng.integers(0, 2, size=368).astype(np.uint8)
        out = np.zeros(368, dtype=np.uint8)
        for i in range(368):
            out[(i * 45 + 92 * i * i) % 368] = x[i]
        assert np.array_equal(np.asarray(interleave.interleave(jnp.asarray(x))), out)


class TestWhiten:
    def test_hard_involution(self):
        rng = np.random.default_rng(5)
        x = jnp.asarray(rng.integers(0, 2, size=(3, 368), dtype=np.uint8))
        assert jnp.array_equal(whiten.whiten_bits(whiten.whiten_bits(x)), x)

    def test_soft_matches_hard(self):
        rng = np.random.default_rng(6)
        b = rng.integers(0, 2, size=368).astype(np.uint8)
        soft = jnp.asarray(b.astype(np.float32) * 2 - 1)
        wb = whiten.whiten_bits(jnp.asarray(b))
        ws = whiten.whiten_soft(soft)
        assert jnp.array_equal((ws > 0).astype(jnp.uint8), wb)


class TestPuncture:
    @pytest.mark.parametrize(
        "scheme,coded,expect",
        [("p1", 488, 368), ("p2", 296, 272), ("p3", 420, 368), ("p2", 402, 369)],
    )
    def test_lengths(self, scheme, coded, expect):
        """Frame-type coded/punctured sizes (m17_rx_parse.cpp:93,138,168).
        BERT (m17_tx_routines.cpp:226-238) punctures 402 of its 410 coded
        bits -> 369, then transmits only the first 368."""
        assert puncture.punctured_len(scheme, coded) == expect

    def test_puncture_depuncture_adjoint(self):
        rng = np.random.default_rng(7)
        soft = jnp.asarray(rng.normal(size=(2, 488)).astype(np.float32))
        kept = puncture.puncture(soft, "p1")
        back = puncture.depuncture(kept, "p1", 488)
        idx = puncture._indices("p1", 488)
        mask = np.zeros(488, bool)
        mask[idx] = True
        assert jnp.allclose(back[:, jnp.asarray(idx)], kept)
        assert jnp.all(back[:, ~mask] == 0.0)


class TestCallsign:
    def test_roundtrip(self):
        """m17_bit_utils.cpp:256-262 round-trips G4GUO/P."""
        for call in ["G4GUO/P", "AB1CDE", "N0CALL-9", "M17"]:
            word = callsign.encode_callsign(call)
            assert callsign.decode_callsign(word).strip() == call

    def test_broadcast(self):
        assert callsign.decode_callsign(constants.BROADCAST_ADDRESS) == "BROADCAST"


class TestTypeField:
    def test_roundtrip(self):
        t = typefield.M17Type(
            packet_stream=1, data_type=2, enc_type=0, enc_subtype=0, can=5
        )
        assert typefield.M17Type.unpack(t.pack()) == t

    def test_field_layout(self):
        # p_s at bit 0, dt at bits 1..2 (m17defines.h:26-31)
        t = typefield.M17Type(packet_stream=1, data_type=2)
        assert t.pack() == (2 << 1) | 1


class TestPrbs:
    def test_sequence_period_and_balance(self):
        seq = prbs.PRBS9_SEQUENCE
        assert len(seq) == 511
        assert seq.sum() == 256  # maximal-length: 256 ones, 255 zeros

    def test_tx_window_wraps(self):
        w = prbs.tx_window(jnp.array([510]), 3)
        expected = [prbs.PRBS9_SEQUENCE[510], prbs.PRBS9_SEQUENCE[0], prbs.PRBS9_SEQUENCE[1]]
        assert w[0].tolist() == expected

    def test_align_and_count(self):
        rx = prbs.tx_window(jnp.array([37, 200]), 197)
        errors, shift = prbs.align_and_count_errors(rx)
        assert errors.tolist() == [0, 0]
        assert shift.tolist() == [37, 200]

    def test_counts_bit_errors(self):
        rx = np.asarray(prbs.tx_window(jnp.array([5]), 197)).copy()
        rx[0, [3, 50, 100]] ^= 1
        errors, shift = prbs.align_and_count_errors(jnp.asarray(rx))
        assert int(errors[0]) == 3
        assert int(shift[0]) == 5


class TestSyncPatterns:
    def test_link_sync_signs(self):
        """0x55F7 dibits -> symbols +3+3+3+3-3-3+3-3 -> signs
        (m17_rx_frame.cpp:7)."""
        assert constants.SYNC_PATTERNS[constants.FT_LINK].tolist() == [
            1, 1, 1, 1, -1, -1, 1, -1]

    def test_stream_sync_signs(self):
        assert constants.SYNC_PATTERNS[constants.FT_STREAM].tolist() == [
            -1, -1, -1, -1, 1, 1, -1, 1]

    def test_packet_bert_eot(self):
        assert constants.SYNC_PATTERNS[constants.FT_PACKET].tolist() == [
            1, -1, 1, 1, -1, -1, -1, -1]
        assert constants.SYNC_PATTERNS[constants.FT_BERT].tolist() == [
            -1, 1, -1, -1, 1, 1, 1, 1]
        assert constants.SYNC_PATTERNS[constants.FT_EOT].tolist() == [
            1, 1, 1, 1, 1, 1, -1, 1]


class TestPrbsStreamChecker:
    """check_stream: the reference-faithful BERT accounting
    (m17_prbs9.cpp:40-64 hysteresis semantics)."""

    def _frames(self, nf, start=0):
        return np.stack([
            np.asarray(prbs.tx_window(
                (start + i * prbs.BERT_FRAME_BITS) % prbs.PRBS9_LEN,
                prbs.BERT_FRAME_BITS))
            for i in range(nf)])

    def test_clean_stream_zero_errors(self):
        e, n, _ = prbs.check_stream(self._frames(8))
        assert (e, n) == (0, 8 * prbs.BERT_FRAME_BITS)

    def test_burst_frame_counted_at_predicted_shift(self):
        f = self._frames(6)
        f[3, 50:90] ^= 1                    # 40-bit burst in one frame
        e, n, _ = prbs.check_stream(f)
        # counted at the PREDICTED alignment: the full 40 (a per-frame
        # best-shift alignment could undercut heavy bursts)
        assert e == 40, e

    def test_destroyed_frame_charged_half(self):
        f = self._frames(6)
        f[3, 10:190] ^= 1                   # 180/197 bits wrong
        e, n, _ = prbs.check_stream(f)
        # beyond the resync threshold the alignment hypothesis is
        # gone; the frame is charged the 50% a junk frame truly
        # carries, and the stream re-syncs on the next clean frame
        assert e == (prbs.BERT_FRAME_BITS + 1) // 2, e

    def test_dead_link_reports_half(self):
        rng = np.random.default_rng(0)
        f = rng.integers(0, 2, (10, prbs.BERT_FRAME_BITS), np.uint8)
        e, n, _ = prbs.check_stream(f)
        assert abs(e / n - 0.5) < 0.02, e / n

    def test_dropped_frame_costs_one_resync(self):
        f = self._frames(8)
        f = np.delete(f, 3, axis=0)          # gap breaks the prediction
        e, n, _ = prbs.check_stream(f)
        assert e == 0 and n == 7 * prbs.BERT_FRAME_BITS

    def test_device_checker_matches_numpy_walk(self):
        """check_stream_device (the psum-able on-device scan) books
        exactly what the numpy check_stream walk books, per channel,
        across clean / burst / destroyed / dead-link / gap content."""
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        nch, s = 6, 10
        bv = np.zeros((nch, s), bool)
        bb = np.zeros((nch, s, prbs.BERT_FRAME_BITS), np.uint8)
        for ch in range(nch):
            nf = int(rng.integers(0, s + 1))
            frames = self._frames(nf) if nf else np.zeros(
                (0, prbs.BERT_FRAME_BITS), np.uint8)
            if ch == 1 and nf > 2:
                frames[1, 40:90] ^= 1               # burst
            if ch == 2 and nf > 3:
                frames[2, 5:190] ^= 1               # destroyed
            if ch == 3:
                frames = rng.integers(               # dead link
                    0, 2, (nf, prbs.BERT_FRAME_BITS), np.uint8)
            # scatter the frames into random valid slots (gap pattern)
            slots = np.sort(rng.choice(s, nf, replace=False))
            for f, sl in enumerate(slots):
                bv[ch, sl] = True
                bb[ch, sl] = frames[f]
        de, dn, du = prbs.check_stream_device(jnp.asarray(bv),
                                              jnp.asarray(bb))
        for ch in range(nch):
            frames = bb[ch][bv[ch]]
            if len(frames) == 0:
                exp = (0, 0, 0)
            else:
                exp = prbs.check_stream(frames)
            assert (int(de[ch]), int(dn[ch]), int(du[ch])) == exp, ch

    def test_unsynced_frames_reported_separately(self):
        """Estimated error mass is distinguishable from measured: the
        unsynced count tells callers how many frames were booked at the
        synthetic 50% rate (advisor round-3 finding)."""
        f = self._frames(6)
        f[3, 10:190] ^= 1
        e, n, uns = prbs.check_stream(f)
        assert uns == 1
        e, n, uns = prbs.check_stream(self._frames(8))
        assert uns == 0
        rng = np.random.default_rng(0)
        junk = rng.integers(0, 2, (10, prbs.BERT_FRAME_BITS), np.uint8)
        _, _, uns = prbs.check_stream(junk)
        assert uns == 10
