"""Tests for the fused timing-recovery + framer scan.

Digital loopback equivalent to the reference's __TEST__ path
(m17_test.cpp:42-52): TX dibits -> 2-samples/symbol RRC shaping ->
m17_rx_sync_samples -> framer, no FM or discriminator.
"""

import jax
import jax.numpy as jnp
import numpy as np

from m17_sdr.dsp.filters import normalize_gain, rrc_filter
from m17_sdr.frame import rx_frames, tx_frames
from m17_sdr.frame.receiver import ReceiverState, receive_block
from m17_sdr.spec import bits as bitpack
from m17_sdr.spec import callsign
from m17_sdr.spec.constants import FT_LINK, FT_STREAM
from m17_sdr.spec.typefield import M17Type

# 2-samples/symbol shaping filter (m17_test_init, m17_test.cpp:58-61)
_RRC2 = normalize_gain(rrc_filter(0.5, 62, 2), 1.0)
# symbol levels used by the reference test modulator (m17_test.cpp:16)
_TEST_LEVELS = np.array([0.3, 1.0, -0.3, -1.0], dtype=np.float32)


def shape_dibits(dibits: np.ndarray) -> np.ndarray:
    """[B, N] dibits -> [B, 2N] samples at 2 samples/symbol."""
    levels = _TEST_LEVELS[dibits]
    up = np.zeros((levels.shape[0], levels.shape[1] * 2), dtype=np.float32)
    # the reference computes out[0] with taps 1,3,5.. and out[1] with
    # taps 0,2,4.., which is plain upsample-by-2 + full convolution
    up[:, 1::2] = levels
    out = np.stack([np.convolve(row, _RRC2, mode="full")[: up.shape[1]]
                    for row in up])
    return out.astype(np.float32)


def _mk_session_dibits(b, npad_frames=2, nstream=3):
    """preamble x npad + LSF + stream frames -> [B, N] dibits."""
    dst = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6), (b, 1)))
    src = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6), (b, 1)))
    lsf = tx_frames.build_lsf_bytes(
        dst, src, jnp.full((b,), M17Type().pack(), dtype=jnp.uint32),
        jnp.zeros((b, 14), jnp.uint8))
    rng = np.random.default_rng(7)
    payloads = jnp.asarray(rng.integers(0, 256, (b, nstream, 16), dtype=np.uint8))
    frames = [tx_frames.preamble_frame(b)] * npad_frames
    frames.append(tx_frames.build_link_setup_frame(lsf))
    for i in range(nstream):
        frames.append(tx_frames.build_stream_frame(
            lsf, jnp.full((b,), i % 6), jnp.full((b,), i, dtype=jnp.uint32),
            payloads[:, i]))
    frames.append(tx_frames.eot_frame(b))
    dibits = np.concatenate([np.asarray(f) for f in frames], axis=1)
    # trailing idle so the EOT frame completes inside the stream (the
    # reference keys down 40 ms after EOT, m17_tx_rx.cpp:114-115)
    dibits = np.pad(dibits, [(0, 0), (0, 192)])
    return dibits, lsf, payloads


def _run_rx(samples: np.ndarray, block=384):
    """Run receive_block over a [B, T] sample stream; collect events."""
    b, t = samples.shape
    state = ReceiverState.init(b)
    all_frames, all_valid, all_type, all_parse = [], [], [], []
    locked = []
    for i in range(0, t - t % block, block):
        ev, state = receive_block(jnp.asarray(samples[:, i:i + block]), state)
        all_frames.append(np.asarray(ev.frames))
        all_valid.append(np.asarray(ev.frame_valid))
        all_type.append(np.asarray(ev.frame_type))
        all_parse.append(np.asarray(ev.frame_parse))
        locked.append(np.asarray(ev.locked))
    return (np.concatenate(all_frames, axis=1),
            np.concatenate(all_valid, axis=1),
            np.concatenate(all_type, axis=1),
            np.concatenate(all_parse, axis=1),
            np.stack(locked, axis=1))


class TestAcquisitionAndFrames:
    def test_locks_and_extracts_frames(self):
        b = 2
        dibits, lsf, payloads = _mk_session_dibits(b)
        samples = shape_dibits(dibits)
        frames, valid, ftype, parse, locked = _run_rx(samples)

        # channel 0: should have received LSF + 3 stream frames
        got_types = ftype[0][valid[0] & parse[0]]
        assert FT_LINK in got_types
        assert np.sum(got_types == FT_STREAM) >= 3

        # lock must drop after EOT
        assert not locked[0][-1]

    def test_decodes_extracted_stream_frames(self):
        b = 2
        dibits, lsf, payloads = _mk_session_dibits(b)
        samples = shape_dibits(dibits)
        frames, valid, ftype, parse, _ = _run_rx(samples)

        sel = valid & parse & (ftype == FT_STREAM)
        for ch in range(b):
            idx = np.nonzero(sel[ch])[0][:3]
            assert len(idx) == 3
            syms = jnp.asarray(frames[ch][idx])
            dec = rx_frames.decode_stream(rx_frames.demap_frame(syms))
            assert np.array_equal(np.asarray(dec.payload),
                                  np.asarray(payloads[ch]))
            assert np.asarray(dec.fn).tolist() == [0, 1, 2]

    def test_decodes_lsf(self):
        b = 2
        dibits, lsf, _ = _mk_session_dibits(b)
        samples = shape_dibits(dibits)
        frames, valid, ftype, parse, _ = _run_rx(samples)
        sel = valid & parse & (ftype == FT_LINK)
        for ch in range(b):
            idx = np.nonzero(sel[ch])[0]
            assert len(idx) >= 1
            dec = rx_frames.decode_lsf(
                rx_frames.demap_frame(jnp.asarray(frames[ch][idx[:1]])))
            assert bool(dec.crc_ok[0])
            assert np.array_equal(np.asarray(dec.lsf_bytes[0]),
                                  np.asarray(lsf[ch]))

    def test_noise_tolerance(self):
        b = 2
        dibits, lsf, payloads = _mk_session_dibits(b)
        samples = shape_dibits(dibits)
        rng = np.random.default_rng(9)
        samples = samples + rng.normal(0, 0.05, samples.shape).astype(np.float32)
        frames, valid, ftype, parse, _ = _run_rx(samples)
        sel = valid & parse & (ftype == FT_STREAM)
        for ch in range(b):
            idx = np.nonzero(sel[ch])[0][:3]
            assert len(idx) == 3
            dec = rx_frames.decode_stream(
                rx_frames.demap_frame(jnp.asarray(frames[ch][idx])))
            assert np.array_equal(np.asarray(dec.payload),
                                  np.asarray(payloads[ch]))


class TestTimingOffset:
    def test_half_sample_offset_still_locks(self):
        """Static fractional timing offsets exercise nonzero polyphase
        indices (the loop walks m_index, m17_rx_sync.cpp:45-72)."""
        b = 1
        dibits, lsf, payloads = _mk_session_dibits(b, npad_frames=2)
        base = shape_dibits(dibits)[0]
        # fractional delay via linear interpolation
        for frac in [0.25, 0.5, 0.75]:
            delayed = (1 - frac) * base[:-1] + frac * base[1:]
            samples = delayed[None, :]
            frames, valid, ftype, parse, _ = _run_rx(samples)
            sel = valid & parse & (ftype == FT_STREAM)
            assert sel.sum() >= 3, frac
            idx = np.nonzero(sel[0])[0][:3]
            dec = rx_frames.decode_stream(
                rx_frames.demap_frame(jnp.asarray(frames[0][idx])))
            assert np.array_equal(np.asarray(dec.payload),
                                  np.asarray(payloads[0])), frac
