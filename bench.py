#!/usr/bin/env python
"""Throughput of the batched RX pipeline on one GPU.

Runs the FULL batched receiver (front end -> fused timing+framer ->
frame extraction -> demap -> Viterbi/Golay/CRC for all frame types) on
B channels of real modulated M17 signal (int16 planar IQ, the radio HAL
wire format) and reports channel-samples/s.  `vs_baseline` compares
against the reference C++ RX chain measured on a CPU (69.6 M samples/s
single channel; see BASELINE.md).

Content: the staggered multi-session mix from pipeline/benchdata.py
(channels span all session phases every instant -- the steady-state
regime of a 4096-channel deployment).

Configurations, each timed over fixed windows that end in
block_until_ready:
  * headline: one whole staggered session -- 13 HAL blocks = 24960
    samples -- per rx_block call, synced after every call;
  * t1920: one 40 ms HAL block per call, chained over the session (the
    per-dispatch latency config of the live path);
  * viterbi: stream-sized trellises (148 steps) through
    fec.viterbi_decode, the function the pipeline calls.

Exits non-zero when JAX finds no GPU.  Prints ONE JSON line (stdout)
naming the device it ran on.

Usage: python bench.py [batch]
"""

import json
import sys
import time

import numpy as np

REFERENCE_RX_SAMPLES_PER_S = 69_644_203.0  # BASELINE.md, bench_ref.cpp
REFERENCE_VITERBI_FRAMES_PER_S = 179_000.0  # BASELINE.md, bench_ref.cpp
REPS = 5            # timed windows per configuration (median reported)
REP_S = 2.0         # seconds per headline window
T1920_ITERS = 20    # session passes per t1920 window
VIT_CALLS = 500


def main() -> None:
    import jax

    from m17_sdr.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: bench.py measures a GPU; JAX sees {jax.devices()}",
              file=sys.stderr)
        sys.exit(2)
    enable_compile_cache()

    import jax.numpy as jnp

    from m17_sdr.fec.viterbi import viterbi_decode
    from m17_sdr.pipeline.benchdata import make_bench_blocks
    from m17_sdr.pipeline.rx import RxSessionState, rx_block

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    block = 1920
    dev_blocks, nblk = make_bench_blocks(batch, block)
    session = jnp.concatenate(list(dev_blocks), axis=-1)   # [B,2,nblk*1920]
    t_sess = nblk * block

    # ---- headline: one whole session per call, per-call synced ----
    st = RxSessionState.init(batch)
    out, st = rx_block(session, st)
    jax.block_until_ready(out)
    rates = []
    for _ in range(REPS):
        ncalls = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < REP_S:
            out, st = rx_block(session, st)
            jax.block_until_ready(out)
            ncalls += 1
        rates.append(batch * t_sess * ncalls / (time.perf_counter() - t0))
    rates.sort()

    # ---- t1920: one HAL block per call, chained ----
    out, _ = rx_block(dev_blocks[0], RxSessionState.init(batch))
    jax.block_until_ready(out)
    rates_1920 = []
    for _ in range(REPS):
        st = RxSessionState.init(batch)
        t0 = time.perf_counter()
        for _ in range(T1920_ITERS):
            for blk in dev_blocks:
                out, st = rx_block(blk, st)
        jax.block_until_ready(out)
        rates_1920.append(batch * t_sess * T1920_ITERS
                          / (time.perf_counter() - t0))
    rates_1920.sort()

    # ---- Viterbi frames/s on stream-sized trellises (296 depunctured
    # soft bits -> 148 steps; m17_conv.cpp:148-168), chained through a
    # data dependency so calls cannot overlap ----
    vit_soft = jnp.asarray(np.random.default_rng(1).normal(
        size=(batch, 296)).astype(np.float32))

    @jax.jit
    def vit_step(soft, prev_metric):
        s = soft + jnp.where(prev_metric[:1] > 1e30, 1.0, 0.0)
        return viterbi_decode(s, return_metric=True)

    m = jnp.zeros((batch,), jnp.float32)
    bits, m = vit_step(vit_soft, m)
    jax.block_until_ready(bits)
    vit_ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(VIT_CALLS):
            bits, m = vit_step(vit_soft, m)
        jax.block_until_ready(bits)
        vit_ts.append(time.perf_counter() - t0)
    vit_frames_per_s = batch * VIT_CALLS / min(vit_ts)

    samples_per_s = rates[len(rates) // 2]
    print(json.dumps({
        "metric": f"rx_pipeline_channel_samples_per_s_b{batch}",
        "value": round(samples_per_s),
        "unit": "samples/s",
        "vs_baseline": round(samples_per_s / REFERENCE_RX_SAMPLES_PER_S, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "config": {"block_samples": t_sess, "sync": "per_call",
                   "hal_blocks_per_call": nblk, "rep_s": REP_S,
                   "equalize": "off",
                   "rep_rates": [round(r) for r in rates]},
        "t1920_rates": [round(r) for r in rates_1920],
        "viterbi_frames_per_s": round(vit_frames_per_s),
        "viterbi_vs_baseline": round(
            vit_frames_per_s / REFERENCE_VITERBI_FRAMES_PER_S, 1),
    }))


if __name__ == "__main__":
    main()
