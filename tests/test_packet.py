"""Packet mode end to end (BASELINE parity for the reference's packet
path, m17_tx_routines.cpp:201-222 / m17_rx_parse.cpp:161-177 --
dormant there, live here)."""

import jax
import jax.numpy as jnp
import numpy as np

from m17_sdr.frame import tx_frames
from m17_sdr.pipeline import loopback
from m17_sdr.spec import bits as bitpack
from m17_sdr.spec import callsign
from m17_sdr.spec.typefield import CCT_PACKET, M17Type


def _lsf(batch: int) -> jnp.ndarray:
    dst = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6),
        (batch, 1)))
    src = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6),
        (batch, 1)))
    t = M17Type(packet_stream=CCT_PACKET).pack()
    return tx_frames.build_lsf_bytes(
        dst, src, jnp.full((batch,), t, dtype=jnp.uint32),
        jnp.zeros((batch, 14), jnp.uint8))


def test_packet_round_trip_clean():
    rng = np.random.default_rng(7)
    batch, length = 3, 60          # 60+2 CRC -> 3 frames, final 12 bytes
    data = rng.integers(0, 256, (batch, length), dtype=np.uint8)
    out, _ = loopback.packet_loopback(
        jax.random.PRNGKey(0), _lsf(batch), jnp.asarray(data), snr_db=60.0)
    got = loopback.reassemble_packets(out)
    for ch in range(batch):
        assert got[ch] == bytes(data[ch]), f"channel {ch} mismatch"


def test_packet_round_trip_exact_chunk_boundary():
    rng = np.random.default_rng(8)
    batch, length = 2, 48          # 48+2 = 50 -> 2 full frames, final 25
    data = rng.integers(0, 256, (batch, length), dtype=np.uint8)
    out, _ = loopback.packet_loopback(
        jax.random.PRNGKey(1), _lsf(batch), jnp.asarray(data), snr_db=60.0)
    got = loopback.reassemble_packets(out)
    for ch in range(batch):
        assert got[ch] == bytes(data[ch])


def test_packet_survives_moderate_noise():
    # 25 dB: every channel must acquire and reassemble.  (At 20 dB the
    # strict votes==0 acquisition gate, m17_rx_frame.cpp:83, makes
    # single-packet sessions noise-seed dependent -- a packet offers
    # only ~5 sync opportunities vs a voice stream's 25/s.)
    rng = np.random.default_rng(9)
    batch, length = 2, 30
    data = rng.integers(0, 256, (batch, length), dtype=np.uint8)
    out, _ = loopback.packet_loopback(
        jax.random.PRNGKey(2), _lsf(batch), jnp.asarray(data), snr_db=25.0)
    got = loopback.reassemble_packets(out)
    assert all(g == bytes(d) for g, d in zip(got, data))


def test_packet_acquisition_rate_at_20db():
    """Regression guard on RX sensitivity: most channels must still
    acquire a 3-frame packet burst at 20 dB."""
    rng = np.random.default_rng(9)
    batch, length = 16, 30
    data = rng.integers(0, 256, (batch, length), dtype=np.uint8)
    out, _ = loopback.packet_loopback(
        jax.random.PRNGKey(2), _lsf(batch), jnp.asarray(data), snr_db=20.0)
    acquired = int((np.asarray(out.aos).sum(axis=1) > 0).sum())
    assert acquired >= int(0.7 * batch), f"only {acquired}/{batch} acquired"


def test_corrupted_packet_rejected_by_crc():
    rng = np.random.default_rng(10)
    batch, length = 1, 30
    data = rng.integers(0, 256, (batch, length), dtype=np.uint8)
    out, _ = loopback.packet_loopback(
        jax.random.PRNGKey(3), _lsf(batch), jnp.asarray(data), snr_db=60.0)
    # flip a payload byte post-decode: reassembly must reject on CRC
    out = out._replace(packet_data=out.packet_data.at[..., 0].set(
        out.packet_data[..., 0] ^ 0xFF))
    got = loopback.reassemble_packets(out)
    assert got[0] is None


def test_packet_cli_session_roundtrip(tmp_path):
    """User-facing packet mode: tx --packet <file> produces an IQ
    capture that rx --packet-out reassembles byte-exactly (CRC-checked)
    through the full FM chain -- the packet path the reference left
    dormant, surfaced at the CLI."""
    from m17_sdr.app.dbase import Dbase
    from m17_sdr.app.session import Session

    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, 333, dtype=np.uint8)
    src_file = tmp_path / "send.bin"
    src_file.write_bytes(data.tobytes())
    iq = tmp_path / "pkt.iq"

    db = Dbase(tx_src_call="G4GUO", tx_dest_call="AB1CDE")
    stats_tx = Session(db=db).tx_file(str(iq), packet_in=str(src_file))
    assert stats_tx["packet_bytes"] == 333

    out_file = tmp_path / "recv.bin"
    stats_rx = Session().rx_file(str(iq), packet_out=str(out_file))
    assert stats_rx["packet_bytes"] == 333
    assert out_file.read_bytes() == data.tobytes()
    assert stats_rx["lsf"]["src"] == "G4GUO"


def test_packet_cli_rejects_oversize(tmp_path):
    """Files beyond the 823-byte M17 superframe cap (5-bit frame
    counter x 25-byte chunks - CRC) must be rejected, not silently
    emitted with a wrapped counter."""
    import pytest

    from m17_sdr.app.session import Session

    big = tmp_path / "big.bin"
    big.write_bytes(bytes(1000))
    with pytest.raises(ValueError, match="823"):
        Session().tx_file(str(tmp_path / "x.iq"), packet_in=str(big))
