#!/usr/bin/env python
"""End-to-end A/B of the Viterbi decoder on one GPU: Pallas Triton
kernel (what `fec.viterbi_decode` runs on a GPU) vs the XLA scan.

Two configurations, at the bench mix (pipeline/benchdata.py):
  * rx_block at B channels, one whole 13-block session per call, synced
    after every call (bench.py's headline configuration);
  * StreamingRx at B channels in 25-block chunks, fed from host memory
    (the served path: upload, compute, one transfer at the end).

The variants run in turns (xla, kernel, kernel, xla) in one process;
the XLA variant is traced with `viterbi.viterbi_decode` bound to
`viterbi_decode_xla`.  Prints one JSON line with every reading.

Usage: python tools/viterbi_ab.py [batch]
"""

import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SESSION_CALLS = 10
STREAM_CHUNKS = 4
CHUNK_BLOCKS = 25


@contextlib.contextmanager
def decoder(variant: str):
    """Trace everything inside with the chosen Viterbi decoder."""
    import jax

    from m17_sdr.app import streaming
    from m17_sdr.fec import viterbi

    dispatch = viterbi.viterbi_decode
    if variant == "xla":
        viterbi.viterbi_decode = viterbi.viterbi_decode_xla
    jax.clear_caches()
    streaming._chunk_fn.cache_clear()
    try:
        yield
    finally:
        viterbi.viterbi_decode = dispatch


def time_rx_block(session, batch):
    import jax

    from m17_sdr.pipeline.rx import RxSessionState, rx_block

    st = RxSessionState.init(batch)
    out, st = rx_block(session, st)
    jax.block_until_ready(out)
    ts = []
    for _ in range(SESSION_CALLS):
        t0 = time.perf_counter()
        out, st = rx_block(session, st)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def time_streaming(host_blocks, batch):
    from m17_sdr.app.streaming import StreamingRx

    def run(nchunks):
        srx = StreamingRx(batch=batch, chunk_blocks=CHUNK_BLOCKS)
        n = nchunks * CHUNK_BLOCKS
        t0 = time.perf_counter()
        srx.run(iter([host_blocks[i % len(host_blocks)] for i in range(n)]))
        srx.finish()
        return time.perf_counter() - t0

    run(1)                                        # compile
    return run(STREAM_CHUNKS) / STREAM_CHUNKS


def main():
    import jax
    import jax.numpy as jnp

    from m17_sdr.compile_cache import enable_compile_cache
    from m17_sdr.pipeline.benchdata import make_bench_blocks

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"error: viterbi_ab measures a GPU; JAX sees {jax.devices()}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    blocks, nblk = make_bench_blocks(batch)
    session = jnp.concatenate(blocks, axis=-1)
    host = [np.asarray(b).transpose(0, 2, 1) for b in blocks]
    t_sess = session.shape[-1]

    res = {"card": card, "device_kind": dev.device_kind, "batch": batch,
           "rx_block_ms": {"xla": [], "kernel": []},
           "streaming_chunk_ms": {"xla": [], "kernel": []}}
    for variant in ("xla", "kernel", "kernel", "xla"):
        with decoder(variant):
            t_rx = time_rx_block(session, batch)
            t_st = time_streaming(host, batch)
        res["rx_block_ms"][variant].append(round(t_rx * 1e3, 3))
        res["streaming_chunk_ms"][variant].append(round(t_st * 1e3, 3))
        print(f"{variant}: rx_block {t_rx * 1e3:.2f} ms/call "
              f"({batch * t_sess / t_rx:.4g} channel-samples/s), "
              f"StreamingRx {t_st * 1e3:.1f} ms per {CHUNK_BLOCKS}-block "
              f"chunk [{card}]", file=sys.stderr, flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
