"""End-to-end pipeline tests: the full analog chain over the air-gap.

BASELINE configs: (1) PRBS9 BER loopback, (2) voice frame round trip,
(3) acquisition under offsets/drift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr.pipeline import loopback
from m17_sdr.frame import tx_frames
from m17_sdr.spec import bits as bitpack
from m17_sdr.spec import callsign
from m17_sdr.spec.typefield import M17Type

B = 2
NF = 4


def _mk_lsf(b=B):
    dst = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6), (b, 1)))
    src = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6), (b, 1)))
    return tx_frames.build_lsf_bytes(
        dst, src, jnp.full((b,), M17Type().pack(), dtype=jnp.uint32),
        jnp.zeros((b, 14), jnp.uint8))


def _payloads(b=B, nf=NF, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 256, (b, nf, 16), dtype=np.uint8))


class TestVoiceLoopback:
    def test_clean_channel(self):
        lsf = _mk_lsf()
        pl = _payloads()
        out, state = loopback.voice_loopback(
            jax.random.PRNGKey(0), lsf, pl, snr_db=60.0)
        got, mask = loopback.recover_stream_payloads(out, NF)
        assert mask.all()
        assert np.array_equal(got, np.asarray(pl))
        # session state saw the LSF via LICH or LSF frame
        assert np.all(np.asarray(state.lich_good_valid))
        assert np.array_equal(np.asarray(state.lich_good), np.asarray(lsf))

    def test_clean_channel_zero_golay_errors(self):
        """A clean channel must produce exactly zero Golay errors over a
        full multi-frame session incl. the EOT boundary (the reference
        counts corrected LICH bits, m17_rx_parse.cpp:118-126; a noiseless
        capture must need zero corrections)."""
        lsf = _mk_lsf()
        pl = _payloads(nf=8, seed=7)
        out, state = loopback.voice_loopback(
            jax.random.PRNGKey(7), lsf, pl, snr_db=80.0)
        got, mask = loopback.recover_stream_payloads(out, 8)
        assert mask.all()
        assert np.all(np.asarray(state.golay_errors) == 0)

    def test_moderate_noise(self):
        lsf = _mk_lsf()
        pl = _payloads(seed=1)
        out, _ = loopback.voice_loopback(
            jax.random.PRNGKey(1), lsf, pl, snr_db=20.0)
        got, mask = loopback.recover_stream_payloads(out, NF)
        assert mask.all()
        assert np.array_equal(got, np.asarray(pl))

    def test_carrier_offset(self):
        """Static carrier offset within the discriminator's range."""
        lsf = _mk_lsf()
        pl = _payloads(seed=2)
        out, _ = loopback.voice_loopback(
            jax.random.PRNGKey(2), lsf, pl, snr_db=30.0, freq_offset_hz=100.0)
        got, mask = loopback.recover_stream_payloads(out, NF)
        assert mask.all()
        assert np.array_equal(got, np.asarray(pl))

    def test_clock_drift_with_slips(self):
        """Clock drift exercises the bit-slip insert/delete path
        (m17_rx_sync.cpp:45-72)."""
        lsf = _mk_lsf()
        pl = _payloads(seed=3)
        out, _ = loopback.voice_loopback(
            jax.random.PRNGKey(3), lsf, pl, snr_db=30.0, drift_ppm=100.0)
        got, mask = loopback.recover_stream_payloads(out, NF)
        assert mask.all()
        assert np.array_equal(got, np.asarray(pl))


class TestBertLoopback:
    def test_clean_ber_zero(self):
        errors, counted = loopback.bert_loopback(
            jax.random.PRNGKey(4), batch=2, n_frames=4, snr_db=60.0)
        assert np.all(np.asarray(counted) >= 3 * 197)
        assert np.all(np.asarray(errors) == 0)

    def test_noisy_ber_small(self):
        errors, counted = loopback.bert_loopback(
            jax.random.PRNGKey(5), batch=2, n_frames=4, snr_db=20.0)
        counted = np.asarray(counted)
        assert counted.sum() > 0
        ber = np.asarray(errors).sum() / counted.sum()
        assert ber < 0.02


class TestChannelIndependence:
    def test_batched_equals_single(self):
        """N batched channels must decode identically to N independent
        runs -- the core guarantee of channel parallelism."""
        lsf = _mk_lsf(2)
        pl = _payloads(2, NF, seed=6)
        # batched run (no noise so runs are deterministic/comparable)
        out_b, _ = loopback.voice_loopback(
            jax.random.PRNGKey(6), lsf, pl, snr_db=80.0)
        got_b, mask_b = loopback.recover_stream_payloads(out_b, NF)
        # per-channel runs
        for ch in range(2):
            out_s, _ = loopback.voice_loopback(
                jax.random.PRNGKey(6), lsf[ch:ch + 1], pl[ch:ch + 1],
                snr_db=80.0)
            got_s, mask_s = loopback.recover_stream_payloads(out_s, NF)
            assert np.array_equal(mask_s[0], mask_b[ch])
            assert np.array_equal(got_s[0], got_b[ch])


class TestFnContinuityGate:
    """Round-4 routing gate: a stream frame's FN must advance 1..16
    past the anchor (pipeline/rx.py STREAM_FN_WINDOW); every quality-
    passing frame re-anchors; a fresh session accepts any FN."""

    def _run_session(self, fn0):
        from m17_sdr.pipeline import tx as txp
        from m17_sdr.pipeline.loopback import _blockify
        from m17_sdr.pipeline.rx import RxSessionState, rx_stream

        lsf = _mk_lsf(1)
        pl = _payloads(1, 8, seed=3)
        dibits = txp.build_voice_session_dibits(
            lsf, pl, fn0=jnp.asarray([fn0], jnp.uint32))
        iq, _ = txp.dibits_to_iq(dibits)
        out, _ = rx_stream(_blockify(iq), RxSessionState.init(1))
        gate = np.asarray(out.stream_gate[0]).reshape(-1)
        fn = np.asarray(out.stream_fn[0]).reshape(-1)
        return fn[np.nonzero(gate)[0]]

    def test_sequential_frames_all_routed(self):
        fns = self._run_session(0)
        assert list(fns) == list(range(8))

    def test_fn_wraps_at_15_bits_and_keeps_routing(self):
        """FN is 15-bit on the wire: the MSB is the M17 end-of-stream
        marker, so the TX counter must wrap 0x7FFF -> 0 instead of
        running into it (the reference wraps at 0xFFFF and leaks the
        EOS bit after 32768 frames, m17_tx_routines.cpp:170).  The RX
        FN gate's 15-bit delta treats the wrap as a normal +1 step."""
        fns = self._run_session(0x7FFD)
        assert list(fns) == [0x7FFD, 0x7FFE, 0x7FFF, 0, 1, 2, 3, 4]
        assert all(f < 0x8000 for f in fns)

    def test_mid_stream_join_any_start_fn(self):
        """A session starting at an arbitrary FN routes fully: the
        fresh-session anchor accepts any first FN (mid-stream join,
        the capability LICH reassembly exists for)."""
        fns = self._run_session(12345)
        assert list(fns) == list(range(12345, 12345 + 8))

    def test_discontinuous_fn_rejected_then_self_heals(self):
        """A confident misframe (absurd FN mid-stream) must not route;
        the anchor follows it, so exactly one clean frame after it is
        sacrificed and the stream recovers."""
        from m17_sdr.pipeline import tx as txp
        from m17_sdr.pipeline.loopback import _blockify
        from m17_sdr.pipeline.rx import RxSessionState, rx_stream

        # splice two sessions' FN spaces: frames 0..3 at fn 0..3, then
        # 4..7 at fn 5000.. -- the jump mimics a decoded misframe run
        from m17_sdr.frame import tx_frames
        lsf = _mk_lsf(1)
        pl = _payloads(1, 8, seed=4)
        d1 = txp.build_voice_session_dibits(
            lsf, pl[:, :4], fn0=jnp.asarray([0], jnp.uint32))
        # second half WITHOUT preamble/LSF/EOT boundary: build frames
        # directly and splice before the first session's EOT
        idx = jnp.arange(4, dtype=jnp.uint32)
        stream2 = tx_frames.build_stream_frame(
            jnp.repeat(lsf, 4, axis=0),
            (idx % 6 + 4).astype(jnp.int32),
            5000 + idx, pl[0, 4:8]).reshape(1, -1)
        from m17_sdr.spec.constants import FRAME_SYMBOLS
        eot_start = d1.shape[1] - 2 * FRAME_SYMBOLS  # EOT + idle tail
        dibits = jnp.concatenate(
            [d1[:, :eot_start], stream2, d1[:, eot_start:]], axis=1)
        iq, _ = txp.dibits_to_iq(dibits)
        out, _ = rx_stream(_blockify(iq), RxSessionState.init(1))
        gate = np.asarray(out.stream_gate[0]).reshape(-1)
        fn = np.asarray(out.stream_fn[0]).reshape(-1)
        sv = np.asarray(out.stream_valid[0]).reshape(-1)
        routed = fn[np.nonzero(gate)[0]]
        delivered = fn[np.nonzero(sv)[0]]
        # all 8 frames decoded; fn 0..3 route, the first jumped frame
        # (5000) is rejected, the stream re-anchors and routes the rest
        assert list(delivered) == [0, 1, 2, 3, 5000, 5001, 5002, 5003]
        assert list(routed) == [0, 1, 2, 3, 5001, 5002, 5003]


class TestSessionGranularityDecode:
    """The bench headline feeds one whole session (13 HAL blocks) per
    rx_block call (BASELINE.md round-5).  Decode at that granularity
    must be real: per-channel control loops tick per call, and every
    channel must still lock and stream in steady state."""

    def test_whole_session_call_decodes_steady_state(self):
        import jax.numpy as jnp

        from m17_sdr.pipeline.benchdata import make_bench_blocks
        from m17_sdr.pipeline.rx import RxSessionState, rx_block

        b = 64
        dev_blocks, nblk = make_bench_blocks(b, 1920)
        session = jnp.concatenate(list(dev_blocks), axis=-1)
        st = RxSessionState.init(b)
        sums = []
        for _ in range(4):
            out, st = rx_block(session, st)
            sums.append(int(np.asarray(st.n_frames).sum()))
        # periodic steady state: the per-channel frames-since-AOS
        # snapshot repeats exactly once sessions restart
        assert sums[1] == sums[2] == sums[3]
        # and every channel holds a locked streaming session (>= 8 of
        # the session's stream frames held since its last AOS)
        nf = np.asarray(st.n_frames)
        assert (nf >= 8).all(), nf.min()

    def test_two_block_call_bit_equals_chained(self):
        import jax.numpy as jnp

        from m17_sdr.pipeline.benchdata import make_bench_blocks
        from m17_sdr.pipeline.rx import RxSessionState, rx_block

        b = 64
        dev_blocks, nblk = make_bench_blocks(b, 1920)
        st1 = RxSessionState.init(b)
        for i in range(12):
            out1, st1 = rx_block(dev_blocks[i], st1)
        st2 = RxSessionState.init(b)
        for i in range(6):
            blk = jnp.concatenate(
                [dev_blocks[2 * i], dev_blocks[2 * i + 1]], axis=-1)
            out2, st2 = rx_block(blk, st2)
        np.testing.assert_array_equal(np.asarray(st1.n_frames),
                                      np.asarray(st2.n_frames))
        np.testing.assert_array_equal(np.asarray(st1.golay_errors),
                                      np.asarray(st2.golay_errors))
        np.testing.assert_array_equal(np.asarray(st1.lich_good),
                                      np.asarray(st2.lich_good))
