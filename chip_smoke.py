#!/usr/bin/env python
"""Run the M17 modem's main path once on a GPU and check what comes out.

    python chip_smoke.py              # phases a-e on one GPU
    python chip_smoke.py --four-gpus  # only phase f, on four GPUs

Phases (one process; no phase's failure is caught):
  a. device: JAX must see GPUs; prints the card, its power limit, the
     JAX version and XLA_FLAGS.
  b. CLI round trip: `tx` then `rx` through `m17_sdr.app.main.main`,
     in-process; callsigns, frame count and payload bytes must match.
  c. full-width batch RX: `rx_block` on the bench session (4096
     channels x 24,960 samples of 48 kS/s int16 IQ per call), with
     the equalizer off and on its shipping default "auto"; every
     channel must decode its LSF and all 8 payloads, and 64 channels
     decoded again on the CPU must agree.
  d. streaming: `StreamingRx` at 4096 channels (2 chunks of 25 blocks,
     48 kS/s) and at 256 channels at 384 kS/s (the x8 decimator) must
     decode what the batch path decodes; one live `rx --udp` session
     (`Session.rx_live`) fed over UDP from a thread must decode the
     phase-b capture.
  e. Viterbi: the Pallas Triton kernel against `viterbi_decode_xla` at
     4096 x 15 trellises for 148, 210 and 244 steps.
  f. (--four-gpus) channel-sharded `sharded_rx_stream` over 4 GPUs
     against `rx_stream` of each shard on one GPU, and
     `halo.time_parallel_rx` on a (2, 2) mesh against the unsharded
     decode.

Times printed here are smoke readings, not benchmarks.  The last line
of standard output is one JSON object, printed only when every phase
passed; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

BATCH = 4096               # channels of the full-width deployment
SESSION_CALLS = 3          # chained whole-session calls (covers 2 sessions)
CPU_CHANNELS = 64          # channels decoded again on the CPU
CHUNK_BLOCKS = 25          # StreamingRx blocks per dispatch (1 s)
STREAM_CHUNKS = 2
PLUTO_BATCH = 256          # channels on the 384 kS/s leg
CLI_FRAMES = 8
VITERBI_SLOTS = 15         # frame slots per channel in a session call
VITERBI_STEPS = (148, 210, 244)
VITERBI_RTOL = 1e-5
# viterbi_metric tolerance GPU vs CPU: the matched-filter bank is bf16
# by design, so each soft symbol may differ by one bf16 rounding
# (2^-8 relative) between backends; the metric is a signed sum of soft
# bits and stays above 0.9 of their magnitude sum on these clean
# frames, so it moves by at most 2^-8 / 0.9 < 2^-7 relative.
METRIC_RTOL = 2.0 ** -7


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card() -> str:
    """The cards' name and power limit as nvidia-smi reports them (one
    "name, limit" entry per card, joined with " | ")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


def require_gpus(n: int) -> None:
    """Exit non-zero unless JAX sees at least n GPUs (no CPU fallback)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        print(f"error: needs {n} GPU(s); JAX sees {devs}", file=sys.stderr)
        sys.exit(2)


def timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def decoded(out) -> dict:
    """The decoded content of an RxBlockOutput as host arrays: every
    mask, and every decoded field zeroed where its mask is off."""
    m = {k: np.asarray(getattr(out, k)) for k in (
        "stream_valid", "stream_gate", "lsf_valid", "packet_valid",
        "bert_valid")}
    def where(mask, x):
        x = np.asarray(x)
        return np.where(mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)),
                        x, 0)
    return {**m,
            "stream_fn": where(m["stream_valid"], out.stream_fn),
            "stream_payload": where(m["stream_valid"], out.stream_payload),
            "lsf_bytes": where(m["lsf_valid"], out.lsf_bytes),
            "packet_data": where(m["packet_valid"], out.packet_data),
            "bert_bits": where(m["bert_valid"], out.bert_bits)}


def same_decode(a: dict, b: dict, what: str) -> None:
    for k in a:
        check(np.array_equal(a[k], b[k]),
              f"{what}: {k} differs in "
              f"{int(np.sum(np.asarray(a[k]) != np.asarray(b[k])))} places")


def concat_blocks(outs: list[dict], axis: int = 1) -> dict:
    return {k: np.concatenate([o[k] for o in outs], axis=axis)
            for k in outs[0]}


# ---------------------------------------------------------------- a
def phase_device(n_gpus: int) -> str:
    import jax

    require_gpus(n_gpus)
    line = card()
    print(f"[a] card: {line}")
    print(f"[a] device_kind={jax.devices()[0].device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return line


# ---------------------------------------------------------------- b
def run_cli(argv: list) -> dict:
    from m17_sdr.app.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli([str(a) for a in argv])
    check(rc == 0, f"CLI {argv[0]} exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def sent_cli_payloads() -> bytes:
    # Session.tx_file's default payloads: seed 0, 16 bytes per frame
    return np.random.default_rng(0).integers(
        0, 256, (1, CLI_FRAMES, 16), dtype=np.uint8).tobytes()


def phase_cli(tmp: pathlib.Path) -> pathlib.Path:
    cap, pay = tmp / "tx.iq", tmp / "rx.bin"
    t0 = time.perf_counter()
    tx = run_cli(["tx", "--out", cap, "--frames", CLI_FRAMES,
                  "--src", "G4GUO", "--dest", "AB1CDE"])
    rx = run_cli(["rx", "--in", cap, "--payload-out", pay])
    check(tx["frames"] == CLI_FRAMES, f"tx frames {tx}")
    check(rx["lsf"] == {"dst": "AB1CDE", "src": "G4GUO"},
          f"rx callsigns {rx['lsf']}")
    check(rx["payload_frames"] == CLI_FRAMES,
          f"rx payload_frames {rx['payload_frames']}")
    check(pay.read_bytes() == sent_cli_payloads(), "rx payload bytes")
    print(f"[b] CLI tx -> rx: {rx['payload_frames']} frames, callsigns "
          f"and payload bytes match ({time.perf_counter() - t0:.1f} s "
          "incl. compile)")
    return cap


# ---------------------------------------------------------------- c
def check_bench_decode(outs: list, lsf: np.ndarray, payloads: np.ndarray,
                       what: str) -> None:
    """Every channel routes exactly its session's 8 payloads (each at
    least once, nothing else) and every decoded LSF is its session's."""
    d = concat_blocks([decoded(o) for o in outs])
    b = d["stream_valid"].shape[0]
    sess = np.arange(b) % lsf.shape[0]
    lsf_ok = d["lsf_valid"]
    check(bool(np.all(lsf_ok.any(axis=1))), f"{what}: a channel saw no LSF")
    want_lsf = np.broadcast_to(lsf[sess][:, None], d["lsf_bytes"].shape)
    check(np.array_equal(d["lsf_bytes"][lsf_ok], want_lsf[lsf_ok]),
          f"{what}: wrong LSF bytes")
    routed = d["stream_valid"] & d["stream_gate"]
    for ch in range(b):
        got = {bytes(p) for p in d["stream_payload"][ch][routed[ch]]}
        want = {bytes(p) for p in payloads[sess[ch]]}
        check(got == want, f"{what}: channel {ch} routed {len(got & want)}"
              f"/{len(want)} payloads and {len(got - want)} others")


def run_session_calls(rx_block, state, session, equalize):
    outs, times = [], []
    for _ in range(SESSION_CALLS):
        (out, state), dt = timed(rx_block, session, state, equalize=equalize)
        outs.append(out)
        times.append(dt)
    return outs, times


def phase_batch_rx(card_line: str):
    import jax
    import jax.numpy as jnp

    from m17_sdr.pipeline import benchdata
    from m17_sdr.pipeline.rx import RxSessionState, rx_block

    blocks, nblk = benchdata.make_bench_blocks(BATCH)
    session = jnp.concatenate(blocks, axis=-1)             # [B, 2, T]
    t_sess = session.shape[-1]
    lsf, payloads = benchdata.bench_content()

    cpu = jax.devices("cpu")[0]
    session_cpu = jax.device_put(session[:CPU_CHANNELS], cpu)
    for eq in ("off", "auto"):
        outs, times = run_session_calls(
            rx_block, RxSessionState.init(BATCH), session, eq)
        check_bench_decode(outs, lsf, payloads, f"rx_block eq={eq}")
        warm = min(times[1:])
        print(f"[c] rx_block B={BATCH} T={t_sess} equalize={eq}: every "
              f"channel decodes its LSF and 8 payloads; smoke reading, "
              f"not a benchmark: first call {times[0]:.2f} s incl. "
              f"compile, warm {warm * 1e3:.2f} ms/call = "
              f"{BATCH * t_sess / warm:.4g} channel-samples/s "
              f"[{card_line}]")

        with jax.default_device(cpu):
            outs_cpu, _ = run_session_calls(
                rx_block, RxSessionState.init(CPU_CHANNELS), session_cpu, eq)
        worst = 0.0
        for i, (g, c) in enumerate(zip(outs, outs_cpu)):
            g64 = jax.tree.map(lambda x: x[:CPU_CHANNELS], g)
            dg, dc = decoded(g64), decoded(c)
            same_decode(dg, dc, f"GPU vs CPU eq={eq} call {i}")
            used = (dg["stream_valid"] | dg["lsf_valid"]
                    | dg["packet_valid"] | dg["bert_valid"])
            mg = np.asarray(g64.viterbi_metric)[used]
            mc = np.asarray(c.viterbi_metric)[used]
            rel = np.abs(mg - mc) / np.maximum(np.abs(mc), 1e-6)
            worst = max(worst, float(rel.max(initial=0.0)))
        check(worst <= METRIC_RTOL,
              f"GPU vs CPU viterbi_metric rel diff {worst:.3g}")
        print(f"[c] GPU vs CPU on {CPU_CHANNELS} channels, eq={eq}: "
              f"decoded bits and bytes identical, viterbi_metric max rel "
              f"diff {worst:.3g} (limit {METRIC_RTOL:.3g})")
    return blocks, nblk


# ---------------------------------------------------------------- d
def chained_rx(blocks, batch: int) -> dict:
    """The batch path: rx_block chained over 48 kS/s device blocks, with
    each block's outputs given the block axis StreamingRx stacks on."""
    import jax

    from m17_sdr.pipeline.rx import RxSessionState, rx_block

    st = RxSessionState.init(batch)
    outs = []
    for blk in blocks:
        out, st = rx_block(blk, st)
        outs.append(decoded(jax.tree.map(lambda x: x[:, None], out)))
    return concat_blocks(outs)


def streaming_decode(wire_blocks: list, batch: int, rate: int) -> dict:
    from m17_sdr.app.streaming import StreamingRx

    srx = StreamingRx(batch=batch, input_rate=rate,
                      chunk_blocks=CHUNK_BLOCKS)
    srx.run(iter(wire_blocks))
    out, _, n = srx.finish()
    check(n == len(wire_blocks), f"StreamingRx decoded {n} blocks")
    return decoded(out)


def phase_streaming(blocks, nblk: int, cap: pathlib.Path,
                    card_line: str) -> None:
    import jax.numpy as jnp

    from m17_sdr.dsp import resample
    from m17_sdr.pipeline import benchdata

    n = STREAM_CHUNKS * CHUNK_BLOCKS
    # 48 kS/s at full width: the bench blocks repeated, as wire blocks
    host = [np.asarray(b).transpose(0, 2, 1) for b in blocks]   # [B, T, 2]
    t0 = time.perf_counter()
    got = streaming_decode([host[i % nblk] for i in range(n)], BATCH, 48_000)
    dt = time.perf_counter() - t0
    want = chained_rx([blocks[i % nblk] for i in range(n)], BATCH)
    same_decode(got, want, "StreamingRx 48k vs rx_block")
    check(int(got["stream_gate"].sum()) > 0, "StreamingRx 48k routed nothing")
    print(f"[d] StreamingRx B={BATCH} {STREAM_CHUNKS}x{CHUNK_BLOCKS} "
          f"blocks at 48 kS/s equals the batch path; smoke reading: "
          f"{dt:.2f} s incl. compile [{card_line}]")

    # 384 kS/s: the x8 decimating FIR ahead of the modem
    pb, pn = benchdata.make_bench_blocks(PLUTO_BATCH, factor=8)
    host = [np.asarray(b).transpose(0, 2, 1) for b in pb]
    got = streaming_decode([host[i % pn] for i in range(n)], PLUTO_BATCH,
                           384_000)
    wide = jnp.concatenate([pb[i % pn] for i in range(n)], axis=-1)
    dec, _ = resample.decimate_pluto(wide.astype(jnp.float32) * 3.0e-5,
                                     resample.decimate_init(PLUTO_BATCH))
    narrow = dec.shape[-1] // n
    want = chained_rx([dec[..., i * narrow:(i + 1) * narrow]
                       for i in range(n)], PLUTO_BATCH)
    same_decode(got, want, "StreamingRx 384k vs decimate + rx_block")
    check(int(got["stream_gate"].sum()) > 0, "StreamingRx 384k routed nothing")
    print(f"[d] StreamingRx B={PLUTO_BATCH} at 384 kS/s (x8 FIR) equals "
          "the batch path")

    phase_live(cap)


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_live(cap: pathlib.Path) -> None:
    from m17_sdr.app.session import Session
    from m17_sdr.io.sources import FileSource, UdpSampleSink

    port = free_udp_port()
    sender_error: list[BaseException] = []

    def send() -> None:
        try:
            # rx_live binds its port first thing; what arrives while it
            # compiles waits in the transport's queue
            time.sleep(1.0)
            sink = UdpSampleSink("127.0.0.1", port)
            for blk in FileSource(cap).blocks():
                sink.transmit_samples(blk)
            sink.close()
        except BaseException as e:              # re-raised below
            sender_error.append(e)

    with tempfile.TemporaryDirectory() as tmp:
        pay = pathlib.Path(tmp) / "live.bin"
        sender = threading.Thread(target=send, daemon=True)
        sender.start()
        stats = Session().rx_live(port, payload_out=str(pay),
                                  idle_timeout_s=3.0)
        sender.join(timeout=10.0)
        check(not sender.is_alive(), "UDP sender did not finish")
        if sender_error:
            raise sender_error[0]
        check(stats["lsf"] == {"dst": "AB1CDE", "src": "G4GUO"},
              f"rx_live callsigns {stats['lsf']}")
        check(stats["payload_frames"] == CLI_FRAMES,
              f"rx_live payload_frames {stats['payload_frames']}")
        check(pay.read_bytes() == sent_cli_payloads(), "rx_live payload bytes")
    print(f"[d] rx_live over UDP: {stats['payload_frames']} frames in "
          f"{stats['chunks']} chunks, callsigns and payload bytes match")


# ---------------------------------------------------------------- e
def phase_viterbi(card_line: str) -> None:
    import jax
    import jax.numpy as jnp

    from m17_sdr.fec.viterbi import viterbi_decode_xla
    from m17_sdr.fec.viterbi_pallas import viterbi_decode_pallas

    n = BATCH * VITERBI_SLOTS
    for t in VITERBI_STEPS:
        soft = jnp.asarray(np.random.default_rng(t).normal(
            size=(n, 2 * t)).astype(np.float32))
        (bp, mp), _ = timed(viterbi_decode_pallas, soft, return_metric=True)
        (bx, mx), _ = timed(viterbi_decode_xla, soft, return_metric=True)
        check(np.array_equal(np.asarray(bp), np.asarray(bx)),
              f"Viterbi T={t}: kernel bits differ from XLA")
        mp, mx = np.asarray(mp), np.asarray(mx)
        rel = float(np.max(np.abs(mp - mx) / np.maximum(np.abs(mx), 1e-6)))
        check(rel <= VITERBI_RTOL, f"Viterbi T={t}: metric rel diff {rel}")
        tp = min(timed(viterbi_decode_pallas, soft, return_metric=True)[1]
                 for _ in range(5))
        tx = min(timed(viterbi_decode_xla, soft, return_metric=True)[1]
                 for _ in range(5))
        print(f"[e] Viterbi N={n} T={t}: bits identical, metric max rel "
              f"diff {rel:.3g}; smoke reading: Triton kernel "
              f"{tp * 1e3:.3f} ms, XLA scan {tx * 1e3:.3f} ms per call "
              f"[{card_line}]")


# ---------------------------------------------------------------- f
def phase_four_gpus(card_line: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from m17_sdr.mesh import halo, sharding
    from m17_sdr.pipeline import benchdata
    from m17_sdr.pipeline.rx import RxSessionState, rx_stream

    devs = jax.devices()[:4]
    b = 4 * BATCH
    blocks, nblk = benchdata.make_bench_blocks(b)
    iq = jnp.stack(blocks, axis=1)                      # [B, NBLK, 2, T]
    mesh = sharding.make_mesh(4)
    run = sharding.sharded_rx_stream(mesh)
    (out, state, metrics), dt = timed(
        run, sharding.shard_channels(iq, mesh),
        sharding.shard_channels(RxSessionState.init(b), mesh))
    out, state, metrics = jax.device_get((out, state, metrics))
    for k, dev in enumerate(devs):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        ref_out, ref_state = jax.device_get(rx_stream(
            jax.device_put(iq[sl], dev),
            jax.device_put(RxSessionState.init(BATCH), dev)))
        for f in ref_out._fields:
            check(np.array_equal(getattr(out, f)[sl], getattr(ref_out, f)),
                  f"shard {k}: out.{f} differs")
        for f in ref_state._fields:
            for a, r in zip(jax.tree.leaves(getattr(state, f)),
                            jax.tree.leaves(getattr(ref_state, f))):
                check(np.array_equal(a[sl], r), f"shard {k}: state.{f} differs")
    want = [float(np.sum(state.n_frames)), float(np.sum(state.golay_errors)),
            float(np.sum(out.locked[:, -1]))]
    check(np.array_equal(np.asarray(metrics), np.asarray(want, np.float32)),
          f"psum metrics {metrics} != sums {want}")
    print(f"[f] sharded_rx_stream B={b} over 4 GPUs equals rx_stream of "
          f"each shard on one GPU bit for bit; psum metrics "
          f"{[float(x) for x in metrics]} "
          f"equal the sums; smoke reading: {dt:.2f} s incl. compile "
          f"[{card_line}]")

    # time-parallel RX: two time slabs x two replicas, warm-up halo
    reps = 2
    seq = jnp.stack([blocks[i % nblk][:BATCH] for i in range(reps * nblk)],
                    axis=1)                              # [B, 2*NBLK, 2, T]
    tmesh = Mesh(np.array(devs).reshape(2, 2), ("time", "ch"))
    par = halo.time_parallel_rx(tmesh)
    out_par = jax.device_get(par(jax.device_put(
        seq, NamedSharding(tmesh, P(None, "time", None, None)))))
    out_ref = jax.device_get(rx_stream(
        jax.device_put(seq, devs[0]),
        jax.device_put(RxSessionState.init(BATCH), devs[0]))[0])

    def frames(o, ch):
        v = o.stream_valid[ch].reshape(-1)
        return {(int(f), bytes(p)) for f, p in zip(
            o.stream_fn[ch].reshape(-1)[v],
            o.stream_payload[ch].reshape(-1, 16)[v])}

    for ch in range(BATCH):
        missing = frames(out_ref, ch) - frames(out_par, ch)
        check(not missing, f"time_parallel_rx channel {ch} lost "
              f"{len(missing)} frames")
    print(f"[f] time_parallel_rx on a (2, 2) mesh recovers every frame of "
          f"the unsharded decode on {BATCH} channels x {reps * nblk} blocks")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-GPU sharded phase")
    args = p.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import jax

    from m17_sdr.compile_cache import enable_compile_cache

    n_gpus = 4 if args.four_gpus else 1
    card_line = phase_device(n_gpus)
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four_gpus:
        phase_four_gpus(card_line)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            cap = phase_cli(pathlib.Path(tmp))
            blocks, nblk = phase_batch_rx(card_line)
            phase_streaming(blocks, nblk, cap, card_line)
        phase_viterbi(card_line)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
