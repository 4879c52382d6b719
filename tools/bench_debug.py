#!/usr/bin/env python
"""Debug harness for the rx_block throughput mystery.

Modes:
  gen    -- build the real-signal blocks exactly like bench.py and save to /tmp/blocks.npy
  run    -- load /tmp/blocks.npy, time rx_block per-block with block_until_ready
  noise  -- time rx_block on gaussian noise blocks of the same shape
"""

import sys
import time

import numpy as np


def gen(batch, block=1920):
    import jax.numpy as jnp
    from m17_sdr.pipeline import tx as txp
    from m17_sdr.spec import bits as bitpack
    from m17_sdr.spec import callsign
    from m17_sdr.frame import tx_frames
    from m17_sdr.spec.typefield import M17Type

    b0 = 64
    dst = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6), (b0, 1)))
    src = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6), (b0, 1)))
    lsf = tx_frames.build_lsf_bytes(
        dst, src, jnp.full((b0,), M17Type().pack(), dtype=jnp.uint32),
        jnp.zeros((b0, 14), jnp.uint8))
    rng = np.random.default_rng(0)
    payloads = jnp.asarray(rng.integers(0, 256, (b0, 8, 16), dtype=np.uint8))
    dibits = txp.build_voice_session_dibits(lsf, payloads)
    iq, _ = txp.dibits_to_iq(dibits)
    iq = np.asarray(iq)
    nblk = iq.shape[-1] // block
    blocks = np.moveaxis(
        iq[:, :, : nblk * block].reshape(b0, 2, nblk, block), 1, 2)
    blocks = np.tile(blocks, (batch // b0, 1, 1, 1))
    np.save("/tmp/blocks.npy", blocks)
    print("saved", blocks.shape, blocks.dtype)


def run(data):
    import jax
    import jax.numpy as jnp
    from m17_sdr.pipeline.rx import RxSessionState, rx_block

    batch, nblk, _, block = data.shape
    state = RxSessionState.init(batch)
    dev = [jax.device_put(jnp.asarray(data[:, i])) for i in range(nblk)]

    out, st = rx_block(dev[0], state)
    jax.block_until_ready(out)

    # per-block timing with hard sync
    times = []
    st = state
    for i in range(nblk):
        t0 = time.perf_counter()
        out, st = rx_block(dev[i], st)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times = np.array(times) * 1e3
    print(f"per-block ms: min={times.min():.2f} med={np.median(times):.2f} "
          f"max={times.max():.2f}  all={np.round(times,2).tolist()}")
    sps = batch * block / (np.median(times) / 1e3)
    print(f"median throughput: {sps/1e6:.1f} M samples/s")


if __name__ == "__main__":
    mode = sys.argv[1]
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    if mode == "gen":
        gen(batch)
    elif mode == "run":
        run(np.load("/tmp/blocks.npy"))
    elif mode == "noise":
        rng = np.random.default_rng(1)
        shape = np.load("/tmp/blocks.npy", mmap_mode="r").shape
        run(rng.normal(size=shape).astype(np.float32))
