#!/usr/bin/env python
"""Streaming-session throughput / latency on the current backend.

Measures the StreamingRx engine end to end (host blocks -> chunked
device dispatch -> on-device state carry), i.e. the CLI's actual RX
path.  Throughput mode reports a real-time factor (1.0 = keeps up with
one live radio at the input rate); --chunk-latency mode syncs after
every chunk and reports the per-chunk wall distribution (what a live
session's voice latency rides on).  --rate 384000 engages the
Pluto-rate x8 decimating front end (radio.cpp:157-177).  --cpu forces
the CPU backend in-process (the rx_live path's backend).

The timed region excludes compile (one warm chunk first); the final
device->host transfer is excluded from the rate (once per session).

Usage: python tools/streaming_bench.py [batch] [blocks]
         [--rate 48000|384000] [--chunk-blocks N] [--chunk-latency]
         [--cpu] [--runs N]
Prints one JSON line per run.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", type=int, nargs="?", default=1)
    ap.add_argument("blocks", type=int, nargs="?", default=500)
    ap.add_argument("--rate", type=int, default=48_000,
                    choices=[48_000, 384_000])
    ap.add_argument("--chunk-blocks", type=int, default=None)
    ap.add_argument("--chunk-latency", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--equalize", default="auto",
                    choices=["off", "on", "auto"],
                    help="equalizer mode; default auto = the shipping "
                         "session default (rx_file/rx_live), so the "
                         "artifact measures the CLI's actual RX path")
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from m17_sdr.app.streaming import (
        DEFAULT_CHUNK_BLOCKS, StreamingRx)
    from m17_sdr.spec.constants import BLOCK_SAMPLES

    batch, n_blocks = args.batch, args.blocks
    factor = args.rate // 48_000
    block_in = BLOCK_SAMPLES * factor
    chunk_blocks = args.chunk_blocks or DEFAULT_CHUNK_BLOCKS
    platform = jax.devices()[0].platform

    rng = np.random.default_rng(0)
    blocks = [rng.integers(-8000, 8000, (batch, block_in, 2),
                           dtype=np.int16) for _ in range(50)]

    def mk():
        return StreamingRx(batch=batch, input_rate=args.rate,
                           chunk_blocks=chunk_blocks,
                           equalize=args.equalize)

    # warm: compile the chunk fn (flush: uploads are double-buffered,
    # so one chunk alone would only stage, not compute)
    warm = mk()
    for i in range(chunk_blocks):
        warm.feed_block(blocks[i % 50])
    warm.flush_pending()
    jax.block_until_ready(warm._state.rx.receiver.flock)

    for _ in range(args.runs):
        srx = mk()
        if args.chunk_latency:
            # per-chunk latency: sync after every chunk dispatch --
            # the wall a live session would see from last sample of a
            # chunk to its decoded output being ready
            lats = []
            i = 0
            n_chunks = max(1, n_blocks // chunk_blocks)
            for _ in range(n_chunks):
                t0 = time.perf_counter()
                for _ in range(chunk_blocks):
                    srx.feed_block(blocks[i % 50])
                    i += 1
                srx.flush_pending()
                jax.block_until_ready(srx._state.rx.receiver.flock)
                lats.append(time.perf_counter() - t0)
            lats_ms = sorted(l * 1e3 for l in lats)
            chunk_signal_ms = chunk_blocks * BLOCK_SAMPLES / 48.0
            print(json.dumps({
                "mode": "chunk_latency", "platform": platform,
                "equalize": args.equalize,
                "batch": batch, "rate": args.rate,
                "chunk_blocks": chunk_blocks,
                "chunk_signal_ms": round(chunk_signal_ms, 1),
                "chunks": len(lats_ms),
                "chunk_wall_ms": {
                    "min": round(lats_ms[0], 2),
                    "med": round(lats_ms[len(lats_ms) // 2], 2),
                    "p90": round(lats_ms[int(len(lats_ms) * 0.9)], 2),
                    "max": round(lats_ms[-1], 2)},
                "realtime_margin_med": round(
                    chunk_signal_ms / lats_ms[len(lats_ms) // 2], 1),
            }))
            continue
        t0 = time.perf_counter()
        for i in range(n_blocks):
            srx.feed_block(blocks[i % 50])
        srx.flush_pending()                  # drain the staged chunk too
        jax.block_until_ready(srx._state.rx.receiver.flock)
        dt = time.perf_counter() - t0

        signal_seconds = n_blocks * block_in / args.rate
        print(json.dumps({
            "mode": "throughput", "platform": platform,
            "equalize": args.equalize,
            "batch": batch, "rate": args.rate, "blocks": n_blocks,
            "wall_s": round(dt, 3),
            "channel_samples_per_s": round(
                batch * n_blocks * block_in / dt),
            "realtime_factor_per_channel": round(signal_seconds / dt, 1),
            "realtime_channels": round(batch * signal_seconds / dt),
        }))


if __name__ == "__main__":
    main()
