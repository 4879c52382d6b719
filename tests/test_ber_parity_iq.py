"""IQ-domain parity: identical int16 IQ through both chains' COMPLETE
RX paths, front ends included (VERDICT r4 weak #6 -- the soft-domain
harness enters post-discriminator; this one closes the analog seam).
"""

import numpy as np
import pytest

from m17_sdr.pipeline import ber_parity_iq as biq

from test_ber_parity import REF

# the reference chain is compiled from the reference's sources, which
# the repository does not hold
pytestmark = pytest.mark.skipif(not REF.exists(),
                                reason="reference sources absent")


@pytest.mark.parametrize("snr_db,offset_hz", [
    (20.0, 0.0),      # clear channel
    (15.0, 0.0),      # inside the RF waterfall
    (20.0, 300.0),    # carrier offset through both discriminator DC paths
])
def test_iq_domain_agreement(tmp_path, snr_db, offset_hz):
    pts = biq.run_parity_iq([snr_db], nch=4, nf=16,
                            workdir=str(tmp_path),
                            freq_offset_hz=offset_hz)
    p = pts[0]
    assert biq.frame_agreement_ok(p), (p.ref, p.jax)
    assert biq.ber_agreement_ok(p), (p.ref, p.jax)


def test_iq_clear_channel_both_chains_decode(tmp_path):
    """At clear-channel SNR both complete chains must actually recover
    steady-state frames through their real FM front ends -- guards
    against the predicates passing vacuously on an empty decode."""
    pts = biq.run_parity_iq([24.0], nch=4, nf=16, workdir=str(tmp_path))
    p = pts[0]
    assert p.ref[0] >= 0.7 * p.ref[1]
    assert p.jax[0] >= 0.9 * p.jax[1]
    assert p.ref[2] == 0 and p.jax[2] == 0    # zero payload bit errors
