"""FEC tests: encoder linearity, Viterbi correctness, ML optimality."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr.fec import conv, viterbi
from m17_sdr.spec import puncture


def _scalar_encode(bits):
    """Independent scalar model of the shift-register encoder
    (semantics of m17_conv.cpp:33-49, written from the spec)."""
    sr = 0
    out = []
    for b in list(bits) + [0, 0, 0, 0]:
        sr |= int(b) << 4
        out.append(conv.CLUT[sr][0])
        out.append(conv.CLUT[sr][1])
        sr >>= 1
    return np.array(out, dtype=np.uint8)


class TestEncoder:
    def test_matches_scalar_model(self):
        rng = np.random.default_rng(0)
        for n in [8, 21, 144, 240]:
            bits = rng.integers(0, 2, size=n).astype(np.uint8)
            got = np.asarray(conv.conv_encode_bits(jnp.asarray(bits)))
            assert np.array_equal(got, _scalar_encode(bits)), n

    def test_batched(self):
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, size=(5, 40)).astype(np.uint8)
        got = np.asarray(conv.conv_encode_bits(jnp.asarray(bits)))
        for i in range(5):
            assert np.array_equal(got[i], _scalar_encode(bits[i]))

    def test_bytes_entry(self):
        rng = np.random.default_rng(2)
        data = rng.integers(0, 256, size=18, dtype=np.uint8)
        bits = np.unpackbits(data)
        a = np.asarray(conv.conv_encode_bytes(jnp.asarray(data)))
        b = np.asarray(conv.conv_encode_bits(jnp.asarray(bits)))
        assert np.array_equal(a, b)

    def test_output_length(self):
        out = conv.conv_encode_bits(jnp.zeros(240, dtype=jnp.uint8))
        assert out.shape == (488,)


class TestViterbi:
    def test_zero_noise_roundtrip(self):
        rng = np.random.default_rng(3)
        bits = rng.integers(0, 2, size=(8, 144)).astype(np.uint8)
        coded = conv.conv_encode_bits(jnp.asarray(bits))
        soft = coded.astype(jnp.float32) * 2.0 - 1.0
        dec = viterbi.viterbi_decode(soft)
        assert dec.shape == (8, 148)
        assert np.array_equal(np.asarray(dec[:, :144]), bits)
        assert np.all(np.asarray(dec[:, 144:]) == 0)  # tail

    def test_with_noise_and_erasures(self):
        rng = np.random.default_rng(4)
        bits = rng.integers(0, 2, size=(16, 144)).astype(np.uint8)
        coded = np.asarray(conv.conv_encode_bits(jnp.asarray(bits)))
        soft = coded.astype(np.float32) * 2.0 - 1.0
        soft += rng.normal(0, 0.4, soft.shape).astype(np.float32)
        # knock out 10% as erasures
        mask = rng.random(soft.shape) < 0.1
        soft[mask] = 0.0
        dec = np.asarray(viterbi.viterbi_decode(jnp.asarray(soft)))
        assert np.array_equal(dec[:, :144], bits)

    def test_matches_exhaustive_ml(self):
        """The Viterbi output must equal brute-force maximum-likelihood
        over all 2^k messages for short k."""
        rng = np.random.default_rng(5)
        k = 10
        msgs = np.array(list(itertools.product([0, 1], repeat=k)), dtype=np.uint8)
        codewords = np.asarray(conv.conv_encode_bits(jnp.asarray(msgs)))  # [1024, 28]
        signs = codewords.astype(np.float32) * 2 - 1
        for trial in range(20):
            true = rng.integers(0, 2, size=k).astype(np.uint8)
            tx = np.asarray(conv.conv_encode_bits(jnp.asarray(true))).astype(np.float32) * 2 - 1
            r = tx + rng.normal(0, 1.0, tx.shape).astype(np.float32)
            # ML = max correlation
            ml = msgs[np.argmax(signs @ r)]
            dec = np.asarray(viterbi.viterbi_decode(jnp.asarray(r)))[:k]
            assert np.array_equal(dec, ml), trial

    def test_punctured_roundtrip(self):
        """Stream-frame shaped: 18 bytes -> 296 coded -> P2 272 -> erase
        back to 296 -> Viterbi (m17_rx_parse.cpp:138-140)."""
        rng = np.random.default_rng(6)
        data = rng.integers(0, 2, size=(4, 144)).astype(np.uint8)
        coded = conv.conv_encode_bits(jnp.asarray(data))
        kept = puncture.puncture(coded, "p2")
        assert kept.shape[-1] == 272
        soft = puncture.depuncture(kept.astype(jnp.float32) * 2 - 1, "p2", 296)
        dec = np.asarray(viterbi.viterbi_decode(soft))
        assert np.array_equal(dec[:, :144], data)

    def test_metric_output(self):
        bits = jnp.zeros((2, 40), dtype=jnp.uint8)
        coded = conv.conv_encode_bits(bits)
        soft = coded.astype(jnp.float32) * 2 - 1
        dec, metric = viterbi.viterbi_decode(soft, return_metric=True)
        # clean decode: every branch contributes +2 (both bits match)
        assert np.allclose(np.asarray(metric), 2.0 * 44)
