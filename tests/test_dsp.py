"""DSP unit tests: filters, modulator, discriminator, planar IQ."""

import jax
import jax.numpy as jnp
import numpy as np

from m17_sdr.dsp import channel, iq as iqp
from m17_sdr.dsp.discriminator import RxFrontEndState, rx_front_end
from m17_sdr.dsp.filters import (
    normalize_gain,
    polyphase_rrc_bank,
    rrc_filter,
    tx_rrc_polyphase,
)
from m17_sdr.dsp.modulate import ModState, iq_to_int16, modulate_dibits
from m17_sdr.spec.constants import DIBIT_TO_PHASE_INC


class TestFilters:
    def test_rrc_symmetric(self):
        h = rrc_filter(0.5, 310, 10)
        np.testing.assert_allclose(h, h[::-1], rtol=1e-5)

    def test_rrc_finite(self):
        # the +0.0001 nudge keeps the denominator nonzero even when
        # 4*B*t/Ts hits +-1 (m17_dsp.cpp:297)
        for ntaps, sps in [(310, 10), (1240, 80), (62, 2), (2480, 160)]:
            h = rrc_filter(0.5, ntaps, sps)
            assert np.all(np.isfinite(h)), (ntaps, sps)

    def test_normalize_gain(self):
        h = normalize_gain(rrc_filter(0.5, 62, 2), 1.0)
        assert abs(h.sum() - 1.0) < 1e-5

    def test_polyphase_bank_shapes(self):
        mf, dmf = polyphase_rrc_bank(40, 31)
        assert mf.shape == (40, 31) and dmf.shape == (40, 31)
        # each matched sub-filter normalized to unit DC gain
        np.testing.assert_allclose(mf.sum(axis=1), 1.0, rtol=1e-5)

    def test_tx_polyphase_unit_branch_gain(self):
        c = tx_rrc_polyphase(10)
        # every polyphase branch sums to ~1 (so a constant phase
        # increment passes through unchanged)
        np.testing.assert_allclose(c.sum(axis=0), 1.0, atol=0.02)


class TestPlanarIq:
    def test_roundtrip(self):
        rng = np.random.default_rng(0)
        z = (rng.normal(size=(3, 16)) + 1j * rng.normal(size=(3, 16)))
        x = iqp.from_complex(z)
        assert x.shape == (3, 2, 16)
        np.testing.assert_allclose(iqp.to_complex(x), z.astype(np.complex64),
                                   rtol=1e-6)

    def test_conj_mul_im(self):
        rng = np.random.default_rng(1)
        a = rng.normal(size=4) + 1j * rng.normal(size=4)
        b = rng.normal(size=4) + 1j * rng.normal(size=4)
        want = np.imag(np.conj(a) * b)
        got = iqp.conj_mul_im(iqp.from_complex(a[None]), iqp.from_complex(b[None]))
        np.testing.assert_allclose(np.asarray(got)[0], want, rtol=1e-5)


class TestModulator:
    def test_constant_dibit_gives_tone(self):
        """A run of +3 dibits must settle to a 2400 Hz tone: phase
        increment pi/10 per 48 kHz sample (m17_modulate.cpp:9)."""
        b = 1
        dibits = jnp.full((b, 64), 1, dtype=jnp.uint8)   # +3 symbols
        iq2, _ = modulate_dibits(dibits, ModState.init(b))
        z = iqp.to_complex(np.asarray(iq2))[0]
        # after filter settling, the per-sample phase step is pi/10
        dph = np.angle(z[400:500] * np.conj(z[399:499]))
        np.testing.assert_allclose(dph, np.pi / 10, atol=1e-3)

    def test_unit_envelope(self):
        rng = np.random.default_rng(2)
        dibits = jnp.asarray(rng.integers(0, 4, (2, 100), dtype=np.uint8))
        iq2, _ = modulate_dibits(dibits, ModState.init(2))
        mags = np.asarray(iqp.magnitude(iq2))
        np.testing.assert_allclose(mags, 1.0, atol=1e-5)   # constant envelope

    def test_streaming_equals_one_shot(self):
        """Block-by-block modulation with carry must equal one shot."""
        rng = np.random.default_rng(3)
        dibits = rng.integers(0, 4, (1, 96), dtype=np.uint8)
        full, _ = modulate_dibits(jnp.asarray(dibits), ModState.init(1))
        st = ModState.init(1)
        parts = []
        for i in range(0, 96, 32):
            part, st = modulate_dibits(jnp.asarray(dibits[:, i:i + 32]), st)
            parts.append(np.asarray(part))
        stitched = np.concatenate(parts, axis=-1)
        np.testing.assert_allclose(stitched, np.asarray(full), atol=1e-4)

    def test_int16_wire(self):
        iq2 = iqp.from_complex(np.ones(4) * (0.5 + 0.5j))
        wire = iq_to_int16(iq2)
        assert wire.shape == (4, 2)
        assert np.all(np.asarray(wire) == int(0.5 * 0x3FFF))


class TestDiscriminator:
    def test_tone_recovers_frequency(self):
        """A pure tone at phase step d must discriminate to ~sin(d)."""
        for d in [np.pi / 10, -np.pi / 30]:
            ph = np.arange(1920) * d
            z = np.exp(1j * ph)[None, :]
            dec, offset, _ = rx_front_end(
                iqp.from_complex(z), RxFrontEndState.init(1),
                in_frame=jnp.zeros(1, bool))
            # DC offset removal subtracts the tone itself; offset is the
            # tone's discriminator value
            np.testing.assert_allclose(float(offset[0]), np.sin(d), atol=2e-3)

    def test_modulate_discriminate_roundtrip(self):
        """4FSK through mod -> limiter -> discriminator recovers each
        symbol level (tested on runs of constant dibits: the raw
        2-samples/symbol output before matched filtering only has an
        open eye for sustained symbols -- random data needs the RRC
        matched filter, exercised by the pipeline tests)."""
        runs = np.repeat(np.array([0, 1, 2, 3, 1, 0, 3, 2]), 24)  # 192 syms
        dibits = runs[None, :].astype(np.uint8)
        iq2, _ = modulate_dibits(jnp.asarray(dibits), ModState.init(1))
        dec, offset, _ = rx_front_end(
            iq2, RxFrontEndState.init(1), in_frame=jnp.zeros(1, bool))
        assert dec.shape == (1, 192 * 2)
        d = np.asarray(dec[0]) + float(offset[0])  # undo DC removal
        incs = np.asarray(DIBIT_TO_PHASE_INC)[runs]
        # the 31-tap TX polyphase filter delays the stream by 15
        # symbols = 30 output samples; average each run's settled tail
        got = d.reshape(8, 48)[:, 34:46].mean(axis=1)
        want = np.sin(incs.reshape(8, 24)[:, 0])
        np.testing.assert_allclose(got, want, atol=0.02)

    def test_block_streaming_equals_one_shot(self):
        rng = np.random.default_rng(5)
        z = (rng.normal(size=(1, 3840)) + 1j * rng.normal(size=(1, 3840)))
        x = iqp.from_complex(z)
        full, _, _ = rx_front_end(x, RxFrontEndState.init(1),
                                  in_frame=jnp.zeros(1, bool))
        st = RxFrontEndState.init(1)
        parts = []
        for i in range(0, 3840, 1920):
            p, _, st = rx_front_end(x[..., i:i + 1920], st,
                                    in_frame=jnp.zeros(1, bool))
            parts.append(np.asarray(p))
        stitched = np.concatenate(parts, axis=-1)
        # block-wise DC offset estimation differs between split/unsplit
        # (the reference has the same property); signs must agree away
        # from zero
        f = np.asarray(full)
        big = np.abs(f) > 0.2
        assert (np.sign(stitched[big]) == np.sign(f[big])).mean() > 0.95


class TestChannel:
    def test_awgn_power(self):
        key = jax.random.PRNGKey(0)
        x = iqp.from_complex(np.ones((4, 4096), np.complex64))
        y = channel.awgn(key, x, snr_db=10.0)
        noise = np.asarray(y - x)
        p = (noise ** 2).sum(axis=-2).mean()
        np.testing.assert_allclose(p, 0.1, rtol=0.1)

    def test_carrier_offset_rotates(self):
        x = iqp.from_complex(np.ones((1, 480), np.complex64))
        y = channel.carrier_offset(x, 100.0)
        z = iqp.to_complex(np.asarray(y))[0]
        dph = np.angle(z[1:] * np.conj(z[:-1]))
        np.testing.assert_allclose(dph, 2 * np.pi * 100 / 48000, atol=1e-5)

    def test_timing_drift_identity_at_zero(self):
        rng = np.random.default_rng(6)
        z = rng.normal(size=(1, 2, 64)).astype(np.float32)
        y = channel.timing_drift(jnp.asarray(z), 0.0)
        np.testing.assert_allclose(np.asarray(y)[..., :-1], z[..., :-1],
                                   atol=1e-6)
