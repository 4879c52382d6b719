"""RSSI metering + software AGC servo (radio_rssi_update, radio.cpp:224-265)."""

import jax.numpy as jnp
import numpy as np

from m17_sdr.dsp.discriminator import (
    AGC_GAIN_MAX,
    AGC_HIGH,
    AGC_LOW,
    RxFrontEndState,
    rx_front_end,
)


def _run_blocks(amplitude: float, n_blocks: int = 30, batch: int = 2):
    rng = np.random.default_rng(0)
    state = RxFrontEndState.init(batch)
    in_frame = jnp.zeros((batch,), bool)
    for _ in range(n_blocks):
        ph = rng.uniform(0, 2 * np.pi, size=(batch, 1920))
        iq = amplitude * np.stack([np.cos(ph), np.sin(ph)], axis=1)
        _, _, state = rx_front_end(
            jnp.asarray(iq.astype(np.float32)), state, in_frame)
    return state


def test_rssi_converges_to_input_level():
    state = _run_blocks(amplitude=0.6)
    np.testing.assert_allclose(np.asarray(state.rssi), 0.6, atol=0.05)


def test_agc_steps_up_on_weak_signal():
    state = _run_blocks(amplitude=AGC_LOW / 4)
    assert np.all(np.asarray(state.agc_gain) > 1.0)
    assert np.all(np.asarray(state.agc_gain) <= AGC_GAIN_MAX)


def test_agc_steps_down_on_strong_signal():
    state = _run_blocks(amplitude=2 * AGC_HIGH)
    assert np.all(np.asarray(state.agc_gain) < 1.0)


def test_agc_holds_in_band():
    state = _run_blocks(amplitude=0.5)
    np.testing.assert_allclose(np.asarray(state.agc_gain), 1.0, atol=1e-6)
