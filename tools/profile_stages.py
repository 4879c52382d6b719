#!/usr/bin/env python
"""Per-stage device-time attribution for the RX pipeline on one GPU.

Methodology: every stage is timed as a per-block *state-chained* loop
(each call consumes the previous call's carry, forcing real sequential
execution) with one block_until_ready after the whole rep, and the
stages' reps are INTERLEAVED round-robin in one process so drift in the
card's clocks cancels instead of booking to whichever leg ran last.

Stages:
  rx_session    full rx_block, ONE WHOLE SESSION (13 HAL blocks = 24960
                samples) per call, per-call synced -- bench.py's
                headline config; reported per 1920-sample HAL-block
                equivalent
  rx_xla        full rx_block at the HAL-block size (the per-dispatch
                latency config)
  front_end     discriminator front end only
  recv_xla      receive_block (receiver + frame extraction)
  viterbi4096   stream-sized Viterbi through fec.viterbi_decode
  decode_typed  demap + all four typed frame decoders

The rx_session vs rx_xla delta in the SAME process is the dispatch/
per-call overhead the whole-session config amortizes 13x.

Usage: python tools/profile_stages.py [batch] [--json=out.json]
       [--trace[=dir]]   (adds a jax.profiler trace of rx_block)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ITERS = 40          # passes over the session per rep
REPS = 4


def main():
    import jax
    import jax.numpy as jnp

    from m17_sdr.fec.viterbi import viterbi_decode
    from m17_sdr.frame import rx_frames
    from m17_sdr.frame.receiver import ReceiverState, receive_block
    from m17_sdr.dsp.discriminator import RxFrontEndState, rx_front_end
    from m17_sdr.pipeline.benchdata import make_bench_blocks
    from m17_sdr.pipeline.rx import RxSessionState, rx_block

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"error: profile_stages measures a GPU; JAX sees "
                 f"{jax.devices()}")
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    block = 1920
    dev_blocks, nblk = make_bench_blocks(batch, block)

    # soft-sample blocks for the receiver-only stages: run the front
    # end once (chained) over the session
    fe = RxFrontEndState.init(batch)
    inf = jnp.zeros(batch, bool)
    soft_blocks = []
    for i in range(nblk):
        dec, _, fe = rx_front_end(dev_blocks[i], fe, inf)
        soft_blocks.append(dec)

    # fixed inputs for the stateless stages
    rng = np.random.default_rng(1)
    vit_soft = jnp.asarray(rng.normal(size=(batch, 296)).astype(np.float32))
    frames = jnp.asarray(
        rng.normal(size=(batch * 3, 192)).astype(np.float32))

    @jax.jit
    def viterbi_chained(soft, prev_metric):
        s = soft + jnp.where(prev_metric[:1] > 1e30, 1.0, 0.0)
        bits, metric = viterbi_decode(s, return_metric=True)
        return bits, metric

    @jax.jit
    def decode_typed(fr, prev):
        fr = fr + jnp.where(prev[:1, :1] > 1e30, 1.0, 0.0)
        soft = rx_frames.demap_frame(fr)
        lsf = rx_frames.decode_lsf(soft)
        stream = rx_frames.decode_stream(soft)
        packet = rx_frames.decode_packet(soft)
        bert = rx_frames.decode_bert(soft)
        return (lsf.metric + stream.metric + packet.metric + bert.metric)[
            :, None]

    # --- stage definitions: (name, rep_fn, work_items_per_rep) where a
    # rep runs ITERS chained passes and returns wall seconds.
    def rep_rx():
        st = RxSessionState.init(batch)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            for i in range(nblk):
                out, st = rx_block(dev_blocks[i], st)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    session_blk = jnp.concatenate(list(dev_blocks), axis=-1)

    SESSION_REPEAT = 125   # session calls per rep, per ITERS

    def rep_rx_session():
        # one whole session per call, per-call synced (bench.py's
        # headline configuration)
        st = RxSessionState.init(batch)
        t0 = time.perf_counter()
        for _ in range(ITERS * SESSION_REPEAT):
            out, st = rx_block(session_blk, st)
            jax.block_until_ready(out)
        return time.perf_counter() - t0

    def rep_front_end():
        st = RxFrontEndState.init(batch)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            for i in range(nblk):
                dec, _, st = rx_front_end(dev_blocks[i], st, inf)
        jax.block_until_ready(dec)
        return time.perf_counter() - t0

    def rep_recv():
        st = ReceiverState.init(batch)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            for i in range(nblk):
                ev, st = receive_block(soft_blocks[i], st)
        jax.block_until_ready(ev)
        return time.perf_counter() - t0

    def rep_viterbi():
        m = jnp.zeros((batch,), jnp.float32)
        t0 = time.perf_counter()
        for _ in range(ITERS * nblk):
            bits, m = viterbi_chained(vit_soft, m)
        jax.block_until_ready(bits)
        return time.perf_counter() - t0

    def rep_decode_typed():
        prev = jnp.zeros((batch * 3, 1), jnp.float32)
        t0 = time.perf_counter()
        for _ in range(ITERS * nblk):
            prev = decode_typed(frames, prev)
        jax.block_until_ready(prev)
        return time.perf_counter() - t0

    stages = [
        ("rx_session", rep_rx_session),
        ("rx_xla", rep_rx),
        ("front_end", rep_front_end),
        ("recv_xla", rep_recv),
        ("viterbi4096", rep_viterbi),
        ("decode_typed", rep_decode_typed),
    ]

    # compile everything first (one throwaway rep per stage)
    names = [n for n, _ in stages]
    print(f"batch={batch} nblk={nblk} iters={ITERS} reps={REPS}",
          file=sys.stderr)
    saved_iters = globals()["ITERS"]
    globals()["ITERS"] = 1
    for n, rep in stages:
        rep()
        print(f"compiled {n}", file=sys.stderr)
    globals()["ITERS"] = saved_iters

    # interleaved timed reps
    times = {n: [] for n in names}
    for r in range(REPS):
        for n, rep in stages:
            times[n].append(rep())
        print(f"rep {r + 1}/{REPS} done", file=sys.stderr)

    nb = ITERS * nblk  # blocks per rep
    dev = jax.devices()[0]
    result = {"batch": batch, "nblk": nblk, "iters": ITERS, "reps": REPS,
              "device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "stages": {}}
    for n in names:
        ts = sorted(times[n])
        stage_nb = nb * (SESSION_REPEAT if n == "rx_session" else 1)
        per_block_ms = [t / stage_nb * 1e3 for t in ts]
        result["stages"][n] = {
            "ms_per_block_min": round(per_block_ms[0], 4),
            "ms_per_block_med": round(
                per_block_ms[len(per_block_ms) // 2], 4),
            "samples_per_s": round(batch * block / (per_block_ms[0] / 1e3)),
        }

    s = result["stages"]
    result["derived"] = {
        # per-HAL-block dispatch/launch overhead the session config
        # amortizes: same pipeline, same process, 13 blocks per call
        # vs 1 block per call
        "dispatch_overhead_ms_per_block": round(
            s["rx_xla"]["ms_per_block_min"]
            - s["rx_session"]["ms_per_block_min"], 4),
    }
    print(json.dumps(result, indent=1))

    trace_arg = next((a for a in sys.argv if a.startswith("--trace")), None)
    if trace_arg:
        trace_dir = (trace_arg.split("=", 1)[1]
                     if "=" in trace_arg else "profile_trace")
        st = RxSessionState.init(batch)
        with jax.profiler.trace(trace_dir):
            for i in range(nblk):
                out, st = rx_block(dev_blocks[i], st)
            jax.block_until_ready(out)
        print(f"profiler trace written to {trace_dir}", file=sys.stderr)

    jpath = next((a.split("=", 1)[1] for a in sys.argv
                  if a.startswith("--json=")), None)
    if jpath:
        with open(jpath, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
