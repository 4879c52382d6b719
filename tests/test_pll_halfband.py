"""Dormant-alternate front ends: PLL discriminator + half-band filter.

Reference behaviors: dsp_pll_disc (m17_dsp.cpp:260-291) and
m17_halfband_filter (m17_dsp.cpp:319-343).
"""

import numpy as np
import jax.numpy as jnp

from m17_sdr.dsp import pll

SRATE = 48000.0


def _tone(freq_hz, amp, n, batch=2):
    t = np.arange(n) / SRATE
    ph = 2 * np.pi * freq_hz * t
    x = np.stack([amp * np.cos(ph), amp * np.sin(ph)])
    return jnp.asarray(np.tile(x[None], (batch, 1, 1)).astype(np.float32))


def _raw_vals(out, dc):
    # pll_disc returns out = vals - dc; reconstruct the raw detector
    return np.asarray(out) + np.asarray(dc)[:, None]


class TestPllDisc:
    def test_locks_to_carrier_offset(self):
        # Type-I PLL: steady-state detector output val = -omega/k
        # (z advances by k*val each sample to cancel the carrier's
        # omega).  Offset must sit inside the lock range
        # |omega| <= sqrt(2)*A*k -- with the reference's K = 3e-8 at
        # int16 scale that is ~10 Hz, one reason the path is dormant.
        # Settling time constant is ~1/(k*A*sqrt(2)) ~ 1200 samples,
        # so score the settled tail, not the whole block.
        amp, freq = 20000.0, 5.0
        omega = 2 * np.pi * freq / SRATE
        n = 8 * 1920
        out, dc, st = pll.pll_disc(_tone(freq, amp, n), pll.PllState.init(2))
        assert out.shape == (2, n // 5)
        vals = _raw_vals(out, dc)
        tail = float(vals[0, -vals.shape[1] // 4:].mean())
        np.testing.assert_allclose(tail * pll.PLL_LOOP_GAIN, -omega,
                                   rtol=0.1)

    def test_zero_offset_settles_to_zero(self):
        n = 8 * 1920
        out, dc, _ = pll.pll_disc(_tone(0.0, 20000.0, n),
                                  pll.PllState.init(2))
        vals = _raw_vals(out, dc)
        tail = float(np.abs(vals[0, -vals.shape[1] // 4:]).mean())
        # settled detector output ~0 relative to full scale A*sqrt(2)
        assert tail < 20000.0 * 0.02

    def test_block_split_matches_one_shot(self):
        # carry continuity: two chained blocks == one double block
        amp, freq, n = 20000.0, 5.0, 2 * 1920
        x = _tone(freq, amp, n)
        full, dcf, _ = pll.pll_disc(x, pll.PllState.init(2))
        o1, dc1, st = pll.pll_disc(x[:, :, : n // 2], pll.PllState.init(2))
        o2, dc2, _ = pll.pll_disc(x[:, :, n // 2:], st)
        vals_full = _raw_vals(full, dcf)
        vals_split = np.concatenate(
            [_raw_vals(o1, dc1), _raw_vals(o2, dc2)], axis=-1)
        np.testing.assert_allclose(vals_full, vals_split,
                                   rtol=1e-4, atol=2.0)


class TestHalfband:
    def test_matches_reference_loop(self):
        # direct transcription of m17_halfband_filter's index walk
        flen = 63
        compact = pll.design_halfband(flen)
        rng = np.random.default_rng(0)
        n = 400
        x = rng.integers(-32768, 32767, (2, 2, n)).astype(np.float32)

        h = pll.expand_halfband(compact.astype(np.float32), flen)
        want = np.zeros((2, 2, n - flen + 1), np.float32)
        for i in range(n - flen + 1):
            acc = np.einsum("bct,t->bc", x[:, :, i:i + flen], h)
            want[:, :, i] = np.floor(acc / 32768.0)

        got = np.asarray(pll.halfband_filter(jnp.asarray(x), compact, flen))
        np.testing.assert_allclose(got, want, atol=1.0)

    def test_halfband_zero_taps(self):
        h = pll.expand_halfband(
            pll.design_halfband(63).astype(np.float32), 63)
        c = 31
        # every even offset except the center is exactly zero
        for off in range(2, 31, 2):
            assert h[c + off] == 0.0 and h[c - off] == 0.0

    def test_passband_stopband(self):
        compact = pll.design_halfband(63)
        lo = _tone(1000.0, 10000.0, 2000, batch=1)
        hi = _tone(23000.0, 10000.0, 2000, batch=1)
        ylo = np.asarray(pll.halfband_filter(lo, compact))
        yhi = np.asarray(pll.halfband_filter(hi, compact))
        alo = np.abs(ylo[0, 0] + 1j * ylo[0, 1]).mean()
        ahi = np.abs(yhi[0, 0] + 1j * yhi[0, 1]).mean()
        assert alo > 9000.0  # ~unity passband
        assert ahi < 500.0   # > 25 dB stopband at the band edge
