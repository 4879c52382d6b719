"""Bit-exact parity against golden vectors generated by the *reference*
implementation (tests/golden_gen compiles the reference's freestanding
L3 transforms from /root/reference and dumps these vectors).

Regenerate with:  make -C tests/golden_gen
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr.fec import conv, viterbi
from m17_sdr.spec import bits, callsign, crc, golay, interleave, prbs, puncture, typefield, whiten

GOLDENS = Path(__file__).parent / "goldens" / "goldens.txt"


def _load():
    out = {}
    for line in GOLDENS.read_text().splitlines():
        parts = line.split()
        name, n = parts[0], int(parts[1])
        vals = parts[2:]
        arr = np.array([float(v) for v in vals]) if any("." in v or "e" in v for v in vals) \
            else np.array([int(v) for v in vals], dtype=np.int64)
        assert len(arr) == n, name
        out[name] = arr
    return out


pytestmark = pytest.mark.skipif(not GOLDENS.exists(), reason="goldens not generated")

G = _load() if GOLDENS.exists() else {}


class TestConvParity:
    def test_encode_bytes(self):
        got = conv.conv_encode_bytes(jnp.asarray(G["conv_in_bytes"], dtype=jnp.uint8))
        assert np.array_equal(np.asarray(got), G["conv_out_bits"])

    def test_encode_bits(self):
        """conv_encode_1 of 201 bits (BERT sized)."""
        got = conv.conv_encode_bits(jnp.asarray(G["conv1_in_bits"], dtype=jnp.uint8))
        assert np.array_equal(np.asarray(got), G["conv1_out_bits"])

    def _check_viterbi(self, soft, ref_out, nbits):
        """Our decoder emits the bit entered at step t; the reference
        emits the same sequence delayed one step (m17_conv.cpp:162-166),
        so ref_out[i+1] == ours[i]."""
        got = np.asarray(viterbi.viterbi_decode(jnp.asarray(soft, dtype=jnp.float32)))
        assert np.array_equal(got[: nbits - 1], ref_out[1:nbits])

    def test_viterbi_clean(self):
        soft = G["conv_out_bits"].astype(np.float32) * 2 - 1
        self._check_viterbi(soft, G["viterbi_clean_out"], 244)

    def test_viterbi_noisy(self):
        self._check_viterbi(G["viterbi_noisy_in"].astype(np.float32),
                            G["viterbi_noisy_out"], 244)

    def test_viterbi_stream_punctured(self):
        data = jnp.asarray(G["stream_in_bytes"], dtype=jnp.uint8)
        coded = conv.conv_encode_bytes(data)
        kept = puncture.puncture(coded, "p2")
        assert np.array_equal(np.asarray(kept), G["stream_punc_bits"])
        soft = puncture.depuncture(
            kept.astype(jnp.float32) * 1.8 - 0.9, "p2", 296)
        got = np.asarray(viterbi.viterbi_decode(soft))
        assert np.array_equal(got[:147], G["stream_viterbi_out"][1:148])


class TestGolayParity:
    def test_encode(self):
        data = jnp.asarray(G["golay_data"], dtype=jnp.uint32)
        words = golay.golay_encode(data)
        ref = G["golay_words"].reshape(8, 3)
        ref_words = (ref[:, 0] << 16) | (ref[:, 1] << 8) | ref[:, 2]
        assert np.array_equal(np.asarray(words), ref_words)

    def test_decode(self):
        ref = G["golay_words"].reshape(8, 3)
        ref_words = (ref[:, 0] << 16) | (ref[:, 1] << 8) | ref[:, 2]
        out, nerr = golay.golay_decode(jnp.asarray(ref_words, dtype=jnp.uint32))
        assert np.array_equal(np.asarray(out), G["golay_data"])
        assert np.all(np.asarray(nerr) == 0)


class TestBitPipelineParity:
    def test_puncture_p1(self):
        coded = jnp.asarray(G["conv_out_bits"], dtype=jnp.uint8)
        got = puncture.puncture(coded, "p1")
        assert np.array_equal(np.asarray(got), G["p1_punc_bits"])

    def test_interleave(self):
        got = interleave.interleave(jnp.asarray(G["p1_punc_bits"], dtype=jnp.uint8))
        assert np.array_equal(np.asarray(got), G["interleaved_bits"])

    def test_whiten(self):
        got = whiten.whiten_bits(jnp.asarray(G["interleaved_bits"], dtype=jnp.uint8))
        assert np.array_equal(np.asarray(got), G["whitened_bits"])

    def test_soft_rx_direction(self):
        """Soft de-correlate + de-interleave recovers the punctured bits."""
        soft = jnp.asarray(G["whitened_bits"], dtype=jnp.float32) * 2 - 1
        de = interleave.deinterleave(whiten.whiten_soft(soft))
        assert np.array_equal((np.asarray(de) > 0).astype(np.int64),
                              G["soft_deint_sign"])
        assert np.array_equal((np.asarray(de) > 0).astype(np.int64),
                              G["p1_punc_bits"])


class TestMiscParity:
    def test_crc(self):
        got = int(crc.crc16_fixed(jnp.asarray(G["crc_msg"], dtype=jnp.uint8)))
        assert got == int(G["crc_val"][0])

    def test_callsigns(self):
        assert callsign.encode_callsign("G4GUO") == int(G["call_g4guo"][0])
        assert callsign.encode_callsign("AB1CDE") == int(G["call_ab1cde"][0])

    def test_type_field(self):
        t = typefield.M17Type(packet_stream=1, data_type=2, enc_type=0,
                              enc_subtype=0, can=5, reserved=0)
        assert t.pack() == int(G["type_word"][0])

    def test_prbs9(self):
        got = np.asarray(prbs.tx_window(jnp.array(0), 64))
        assert np.array_equal(got, G["prbs9_first64"])
