"""Measured BER parity vs the reference RX chain (SURVEY.md section 6).

The reference chain (m17_rx_sync.cpp + m17_rx_frame.cpp +
m17_rx_parse.cpp + FEC) is compiled in place from /root/reference by
tests/golden_gen/ber_ref.cpp; both chains decode IDENTICAL noisy
waveforms, so agreement is an implementation comparison on the same
noise realizations, not two independent statistical estimates.
"""

import pathlib

import numpy as np
import pytest

from m17_sdr.pipeline import ber_parity as bp

REF = pathlib.Path("/root/reference/m17gismo")


def test_quality_gate_drops_slip_garbled_frames():
    """Regression for VERDICT round-2 weak #3: at 10 dB a mid-frame
    timing slip garbled one frame's payload tail (25 bit errors) that
    was DELIVERED as valid voice, because M17 stream payloads carry no
    CRC and nothing consumed the exported viterbi_metric.  This
    reproduces that exact waveform (the 10 dB / seed-8000 point of the
    round-2 BER_PARITY.json sweep) and asserts the two-sided fix:

      * pre-gate (stream_valid, round-2 delivery semantics) the
        corrupted frame IS recovered -- the test fails on the old
        behavior by construction;
      * the routed set (stream_gate with the quality threshold)
        contains zero payload bit errors, and still carries the
        overwhelming majority of the good frames.
    """
    import jax.numpy as jnp

    from m17_sdr.pipeline.rx import RxSessionState, rx_stream_soft

    p_sig = bp.signal_power(2, 16)
    sigma = float(np.sqrt(p_sig / (10.0 ** (10.0 / 10.0))))
    wave, payloads = bp.make_waveforms(16, 16, sigma, seed=8000)
    nch, t2 = wave.shape
    blocks = jnp.asarray(wave.reshape(nch, t2 // bp.CHUNK_2X, bp.CHUNK_2X))
    out, _ = rx_stream_soft(blocks, RxSessionState.init(nch))

    sv = np.asarray(out.stream_valid).reshape(nch, -1)
    gate = np.asarray(out.stream_gate).reshape(nch, -1)
    fn = np.asarray(out.stream_fn).reshape(nch, -1)
    pl = np.asarray(out.stream_payload).reshape(nch, -1, 16)
    q = np.asarray(out.stream_quality).reshape(nch, -1)

    err_bits = np.zeros_like(sv, dtype=np.int64)
    steady = np.zeros_like(sv)
    for ch in range(nch):
        for j in np.nonzero(sv[ch])[0]:
            f = int(fn[ch, j])
            if not (8 <= f < 16):
                continue
            steady[ch, j] = True
            err_bits[ch, j] = int(
                np.unpackbits(pl[ch, j] ^ payloads[ch, f]).sum())

    # the round-2 corruption is present pre-gate (stream_valid was the
    # round-2 delivery set) ...
    pre_errs = int(err_bits[steady].sum())
    assert pre_errs >= 20, pre_errs
    # ... every corrupted frame is individually identifiable by the
    # quality measure ...
    corrupted = steady & (err_bits > 0)
    assert corrupted.any()
    assert (q[corrupted] < 0.9).all(), q[corrupted]
    # ... the routed stream is clean ...
    assert int(err_bits[gate & steady].sum()) == 0
    # ... and the quality gate itself costs at most a frame or two of
    # clean recovery (other drops in `sv & ~gate` are the LICH routing
    # gate on late-acquiring channels, same as the reference)
    clean_quality_dropped = steady & (err_bits == 0) & (q < 0.9)
    assert clean_quality_dropped.sum() <= 2, q[clean_quality_dropped]


@pytest.mark.skipif(not REF.exists(), reason="reference sources absent")
class TestBerParity:
    @pytest.fixture(scope="class")
    def points(self, tmp_path_factory):
        td = tmp_path_factory.mktemp("ber")
        # one low-, one waterfall-, one high-SNR point; the full 0-12 dB
        # grid is produced by tools/ber_parity.py -> BER_PARITY.json
        return bp.run_parity([6.0, 9.0, 14.0], nch=6, nf=16,
                             workdir=str(td), seed=3)

    def test_ber_within_binomial_confidence(self, points):
        for p in points:
            assert bp.ber_agreement_ok(p), (p.snr_db, p.ref, p.jax)

    def test_frame_recovery_not_worse_than_reference(self, points):
        for p in points:
            assert bp.frame_agreement_ok(p), (p.snr_db, p.ref, p.jax)

    def test_high_snr_recovery(self, points):
        """At 14 dB this chain must recover nearly every steady-state
        frame with zero payload bit errors.  Not exactly 100%: when a
        channel's optimum timing phase sits at the polyphase wrap, vote
        noise causes an occasional bit-slip whose in-flight frame is
        physically corrupted -- the in-lock resync limits the cost to
        that ONE frame (the reference loses ~7: the slipped frame plus
        its 5-error budget plus re-acquisition)."""
        p = points[-1]
        assert p.jax[0] >= 0.9 * p.jax[1], (p.jax, p.ref)
        assert p.jax[0] >= p.ref[0]
        assert p.jax[2] == 0
