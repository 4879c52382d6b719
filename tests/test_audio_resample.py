"""Audio device layer (audio_io.cpp contract) + Pluto-rate x8 front end."""

import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr.dsp import iq as iqp
from m17_sdr.dsp import resample
from m17_sdr.io import audio


# ---------------------------------------------------------------------------
# audio devices
# ---------------------------------------------------------------------------

def test_wav_round_trip(tmp_path):
    pcm = (np.sin(np.arange(800) * 0.1) * 8000).astype(np.int16)
    p = tmp_path / "a.wav"
    audio.write_pcm(p, pcm)
    back = audio.read_pcm(p)
    np.testing.assert_array_equal(back, pcm)


def test_wav_blocking_reads_in_160_blocks(tmp_path):
    pcm = np.arange(400, dtype=np.int16)   # 2.5 blocks
    p = tmp_path / "a.wav"
    audio.write_pcm(p, pcm)
    src = audio.WavSource(p)
    b1 = src.audio_input()
    b2 = src.audio_input()
    b3 = src.audio_input()                 # short: end of stream
    assert len(b1) == audio.AUDIO_BLOCK and len(b2) == audio.AUDIO_BLOCK
    assert b3 is None
    np.testing.assert_array_equal(np.concatenate([b1, b2]), pcm[:320])


def test_raw_round_trip(tmp_path):
    pcm = np.arange(480, dtype=np.int16)
    p = tmp_path / "a.pcm"
    audio.write_pcm(p, pcm)
    np.testing.assert_array_equal(audio.read_pcm(p), pcm)


def test_wav_rejects_wrong_rate(tmp_path):
    import wave

    p = tmp_path / "bad.wav"
    w = wave.open(str(p), "wb")
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(44100)
    w.writeframes(np.zeros(160, np.int16).tobytes())
    w.close()
    with pytest.raises(ValueError):
        audio.WavSource(p)


def test_loopback_blocking_queue():
    lb = audio.LoopbackAudio()
    pcm = np.arange(320, dtype=np.int16)
    lb.audio_output(pcm)
    a = lb.audio_input()
    b = lb.audio_input()
    np.testing.assert_array_equal(np.concatenate([a, b]), pcm)
    assert lb.audio_input(timeout=0.01) is None


# ---------------------------------------------------------------------------
# decimating FIR
# ---------------------------------------------------------------------------

def test_fir_decimate_blockwise_equals_unsplit():
    rng = np.random.default_rng(0)
    taps = jnp.asarray(resample.pluto_dec_taps())
    x = jnp.asarray(rng.normal(size=(2, 2, 1920)).astype(np.float32))
    y_full, _ = resample.fir_decimate(x, taps, resample.decimate_init(2))
    tail = resample.decimate_init(2)
    outs = []
    for i in range(4):
        y, tail = resample.fir_decimate(x[..., i * 480:(i + 1) * 480],
                                        taps, tail)
        outs.append(y)
    y_split = jnp.concatenate(outs, axis=-1)
    np.testing.assert_allclose(np.asarray(y_full), np.asarray(y_split),
                               atol=1e-6)


def test_fir_decimate_dc_gain_and_shape():
    taps = jnp.asarray(resample.pluto_dec_taps())
    x = jnp.ones((1, 2, 640), jnp.float32)
    y, tail = resample.fir_decimate(x, taps, resample.decimate_init(1))
    assert y.shape == (1, 2, 80)
    assert tail.shape == (1, 2, 30)
    # after the filter delay, DC passes at unit gain
    np.testing.assert_allclose(np.asarray(y[0, 0, 10:]), 1.0, atol=1e-5)


def test_pluto_rate_end_to_end(tmp_path):
    """TX at 384 kS/s -> x8 decimating front end -> full RX decode."""
    from m17_sdr.app.session import Session

    sess = Session()
    sess.db.tx_src_call = "G4GUO"
    sess.db.tx_dest_call = "AB1CDE"
    iq_path = tmp_path / "hi.iq"
    stats_tx = sess.tx_file(str(iq_path), n_frames=6, output_rate=384_000)
    assert stats_tx["samples"] > 0

    out = Session()
    stats = out.rx_file(str(iq_path), input_rate=384_000)
    assert stats["payload_frames"] == 6
    assert stats["lsf"]["src"] == "G4GUO"
    assert stats["lsf"]["dst"] == "AB1CDE"
