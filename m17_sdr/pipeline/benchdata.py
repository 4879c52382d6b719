"""Shared benchmark content: the staggered multi-session channel mix.

Used by bench.py and tools/profile_stages.py so the headline bench and
the per-stage attribution time the SAME workload.

Content: 64 unique voice sessions tiled to B channels, then each
channel's block sequence is cyclically rotated by (channel % nblk)
blocks, so at any instant the channels sit at nblk different session
phases -- hunting, acquiring, locked streaming, EOT -- instead of
marching in lockstep (round-2's mix synchronized all channels and
over-weighted acquisition storms; VERDICT round 2 weak #7).  This is
the steady-state regime a 4096-channel deployment actually runs in.
"""

from __future__ import annotations

import numpy as np

SESSIONS = 64          # unique voice sessions, tiled to the batch


def bench_content():
    """The known content of the bench mix: (lsf [64, 30], payloads
    [64, 8, 16]) as numpy uint8 -- channel c carries session c % 64."""
    import jax.numpy as jnp

    from ..frame import tx_frames
    from ..spec import bits as bitpack
    from ..spec import callsign
    from ..spec.typefield import M17Type

    dst = np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6),
        (SESSIONS, 1))
    src = np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6),
        (SESSIONS, 1))
    lsf = tx_frames.build_lsf_bytes(
        jnp.asarray(dst), jnp.asarray(src),
        jnp.full((SESSIONS,), M17Type().pack(), dtype=jnp.uint32),
        jnp.zeros((SESSIONS, 14), jnp.uint8))
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (SESSIONS, 8, 16), dtype=np.uint8)
    return np.asarray(lsf), payloads


def make_bench_blocks(batch: int, block: int = 1920, int16: bool = True,
                      factor: int = 1):
    """Build the staggered bench mix entirely on device.

    Returns (dev_blocks, nblk): a list of nblk on-device [batch, 2,
    block * factor] planar-IQ arrays, one session's worth of 40 ms
    blocks with per-channel phase stagger.  By default blocks are
    planar int16 -- the radio HAL wire format (48 kHz int16 IQ,
    radio.cpp:157-177), which rx_front_end accepts natively;
    int16=False keeps float32.  factor=8 modulates at the Pluto rate
    (384 kS/s, the TX oversample scaled like the HAL's).
    """
    import jax
    import jax.numpy as jnp

    from . import tx as txp

    lsf, payloads = bench_content()
    dibits = txp.build_voice_session_dibits(
        jnp.asarray(lsf), jnp.asarray(payloads))
    iq, _ = txp.dibits_to_iq(dibits, oversample=10 * factor)  # [64, 2, T]

    b0 = SESSIONS
    block *= factor
    nblk = iq.shape[-1] // block

    @jax.jit
    def make_blocks(iq):
        blk = jnp.moveaxis(
            iq[:, :, : nblk * block].reshape(b0, 2, nblk, block), 1, 2)
        tiled = jnp.tile(blk, (batch // b0, 1, 1, 1))      # [batch,nblk,2,T]
        # de-synchronize: rotate each channel's block sequence so the
        # batch spans all nblk session phases at every step
        offs = jnp.arange(batch) % nblk
        idx = (jnp.arange(nblk)[None, :] + offs[:, None]) % nblk
        out = jnp.take_along_axis(tiled, idx[:, :, None, None], axis=1)
        if int16:
            # quantize to the int16 wire format (inverse of the
            # reference's 3e-5 short->float scale); unit-amplitude FM
            # IQ lands at +-32767 with ~90 dB of quantization SNR
            out = jnp.clip(jnp.round(out / 3.0e-5),
                           -32768, 32767).astype(jnp.int16)
        return out

    blocks = make_blocks(iq)
    dev_blocks = [blocks[:, i] for i in range(nblk)]       # on-device slices
    return dev_blocks, nblk
