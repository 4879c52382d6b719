"""Pallas Triton Viterbi kernel parity vs the XLA lax.scan decoder.

The kernel runs in Pallas interpret mode here (tests execute on the CPU
backend, see conftest.py); on a CUDA GPU the same kernel is what
`fec.viterbi_decode` lowers to.  `chip_smoke.py` phase e runs the
compiled kernel against the XLA decoder on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr.fec import viterbi_pallas
from m17_sdr.fec.conv import conv_encode_bits
from m17_sdr.fec.viterbi import viterbi_decode, viterbi_decode_xla
from m17_sdr.fec.viterbi_pallas import viterbi_decode_pallas

# the four M17 trellis lengths: LSF, stream, packet, BERT
FRAME_STEPS = [244, 148, 210, 205]

TRITON_CALL = "__gpu$xla.gpu.triton"


@pytest.mark.parametrize("t_steps", FRAME_STEPS)
def test_pallas_matches_xla_random_soft(t_steps):
    rng = np.random.default_rng(t_steps)
    soft = jnp.asarray(rng.normal(size=(9, 2 * t_steps)).astype(np.float32))
    b_ref, m_ref = viterbi_decode_xla(soft, return_metric=True)
    b_pal, m_pal = viterbi_decode_pallas(soft, return_metric=True,
                                         interpret=True)
    np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b_pal))
    # same f32 additions in the same order: the metrics are identical
    np.testing.assert_array_equal(np.asarray(m_ref), np.asarray(m_pal))


def test_pallas_decodes_clean_codeword():
    rng = np.random.default_rng(7)
    bits = jnp.asarray(rng.integers(0, 2, (5, 144), dtype=np.uint8))
    coded = conv_encode_bits(bits)
    soft = jnp.where(coded > 0, 1.0, -1.0).astype(jnp.float32)
    out = viterbi_decode_pallas(soft, interpret=True)
    np.testing.assert_array_equal(np.asarray(out[:, :144]), np.asarray(bits))
    assert not np.any(np.asarray(out[:, 144:]))  # zero tail


def test_pallas_erasures_and_batch_shapes():
    rng = np.random.default_rng(3)
    soft = rng.normal(size=(2, 3, 296)).astype(np.float32)
    soft[..., ::7] = 0.0  # depunctured erasures
    soft = jnp.asarray(soft)
    b_ref = viterbi_decode_xla(soft)
    b_pal = viterbi_decode_pallas(soft, interpret=True)
    assert b_pal.shape == (2, 3, 148)
    assert b_pal.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b_pal))


@pytest.mark.parametrize("n", [1, viterbi_pallas._BLOCK - 1,
                               viterbi_pallas._BLOCK + 3])
def test_pallas_pads_trellis_count_to_the_block(n):
    """N not a multiple of the block: the padded trellises decode zeros
    and are sliced off; every real trellis matches the XLA decoder."""
    rng = np.random.default_rng(n)
    soft = jnp.asarray(rng.normal(size=(n, 296)).astype(np.float32))
    b_ref, m_ref = viterbi_decode_xla(soft, return_metric=True)
    b_pal, m_pal = viterbi_decode_pallas(soft, return_metric=True,
                                         interpret=True)
    assert b_pal.shape == (n, 148) and m_pal.shape == (n,)
    np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b_pal))
    np.testing.assert_array_equal(np.asarray(m_ref), np.asarray(m_pal))


def _lowered(platform):
    f = jax.jit(lambda s: viterbi_decode(s, return_metric=True))
    soft = jnp.zeros((5, 296), jnp.float32)
    return f.trace(soft).lower(lowering_platforms=(platform,)).as_text()


def test_dispatch_cpu_lowers_to_the_xla_scan():
    """On the CPU the decoder is the XLA formulation: no Triton call,
    and the results are the XLA decoder's."""
    assert TRITON_CALL not in _lowered("cpu")
    rng = np.random.default_rng(11)
    soft = jnp.asarray(rng.normal(size=(4, 420)).astype(np.float32))
    b, m = viterbi_decode(soft, return_metric=True)
    b_ref, m_ref = viterbi_decode_xla(soft, return_metric=True)
    np.testing.assert_array_equal(np.asarray(b), np.asarray(b_ref))
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m_ref))


def test_dispatch_cuda_lowers_to_the_compiled_kernel():
    """For a CUDA GPU the decoder lowers to the compiled Triton kernel
    itself -- never to interpret mode, and with no XLA fallback."""
    text = _lowered("cuda")
    assert TRITON_CALL in text
    assert "viterbi_k5" in text
    assert "stablehlo.while" not in text   # no lax.scan beside the kernel
