"""CLI entry point.

Reference: main.cpp (CLI args, init order, command thread).  Without
SDR hardware the radio circuits run over file/UDP backends; the MMI
command language and config files are identical in spirit
(`-c config.txt` = mmi_load_file at main.cpp:147).

Examples:
  python -m m17_sdr.app.main tx --out tx.iq --frames 20
  python -m m17_sdr.app.main rx --in tx.iq
  python -m m17_sdr.app.main bert --frames 50 --snr 20
  python -m m17_sdr.app.main repl -c config.txt
"""

from __future__ import annotations

import argparse
import json
import sys

from .dbase import Dbase
from .mmi import Mmi
from .session import Session
from .view import render


def _mk_session(args) -> tuple[Session, Mmi]:
    db = Dbase()
    mmi = Mmi(db=db)
    sess = Session(db=db)
    mmi.on_connect = lambda name, mod: sess.connect(name, mod)
    mmi.on_disconnect = sess.disconnect

    def on_ptt(mode: str) -> None:
        # key/unkey the GPIO transmit line exactly like the MMI's
        # tx/rx/td/tc drive radio_transmit/receive/duplex -> rpi_tx/rx
        # (mmi.cpp:110-131, radio.cpp:74-109)
        if mode in ("tx", "ca", "dp"):
            sess.ptt.set()
        else:
            sess.ptt.clear()
        db.extra["ptt_mode"] = mode

    mmi.on_ptt = on_ptt
    if getattr(args, "config", None):
        mmi.load_file(args.config)
    if getattr(args, "src", None):
        db.tx_src_call = args.src.upper()
    if getattr(args, "dest", None):
        db.tx_dest_call = args.dest.upper()
    return sess, mmi


def _udp_sink(args):
    """Build the TX-side UDP radio sink from --udp-out host:port.

    The datagram block scales with --rate (radio_transmit_samples moves
    rate/25 samples per 40 ms block): a Pluto-rate 384 k stream needs
    15360-sample datagrams or the receiving UdpSampleSource -- which
    sizes its reads the same way -- discards every one.
    """
    from ..io.sources import UdpSampleSink
    from ..spec.constants import BLOCK_SAMPLES

    host, _, port = args.udp_out.rpartition(":")
    return UdpSampleSink(host or "127.0.0.1", int(port),
                         block=BLOCK_SAMPLES * (args.rate // 48_000))


def cmd_tx(args) -> int:
    sess, _ = _mk_session(args)
    if getattr(args, "gps_nmea", None):
        from ..io import gps as gpsm

        reader = gpsm.GpsReader(args.gps_nmea)
        with open(args.gps_nmea, errors="replace") as f:
            for line in f:
                reader.feed(line)
        sess.db.meta = bytes(gpsm.gps_meta_for_lsf(reader.fix))
    if getattr(args, "live", False):
        # open-ended live TX: mic blocks pace the loop, each frame goes
        # out as its audio arrives (PTT_TX with a real microphone,
        # m17_tx_rx.cpp:88-119).  --audio device captures via
        # parec/arecord; sink is UDP (--udp-out) or a capture file
        from ..io.sources import FileSink

        for opt in ("bert", "packet", "payload"):
            if getattr(args, opt, None):
                print(f"error: --live transmits mic voice; --{opt} "
                      "needs a pre-built session (drop --live)",
                      file=sys.stderr)
                return 2
        if args.udp_out:
            sink = _udp_sink(args)
        else:
            sink = FileSink(args.out)
        try:
            stats = sess.tx_live(
                sink, audio_in=args.audio or "device",
                max_frames=args.frames if args.frames else None,
                output_rate=args.rate, pace=args.pace)
        finally:
            sink.close()
        print(json.dumps(stats))
        return 0
    stats = sess.tx_file(args.out, audio_in=args.audio,
                         payload_in=args.payload,
                         n_frames=args.frames if args.frames is not None
                         else 10,
                         output_rate=args.rate,
                         packet_in=getattr(args, "packet", None),
                         bert_frames=getattr(args, "bert", None))
    if getattr(args, "udp_out", None):
        # stream the modulated capture as live IQ block datagrams --
        # the TX leg of the UDP radio contract (radio_transmit_samples
        # with the network as the radio); --pace sends in real time
        import time

        from ..io.sources import FileSource
        from ..spec.constants import BLOCK_SAMPLES

        sink = _udp_sink(args)
        nblk = 0
        for blk in FileSource(
                args.out,
                block=BLOCK_SAMPLES * (args.rate // 48_000)).blocks():
            sink.transmit_samples(blk)
            nblk += 1
            if args.pace:
                time.sleep(0.04)         # one 1920-sample 48 kHz block
        sink.close()
        stats["udp_blocks"] = nblk
    print(json.dumps(stats))
    return 0


def cmd_rx(args) -> int:
    sess, _ = _mk_session(args)
    paths = getattr(args, "in")
    if args.udp is not None:
        if paths:
            print("error: --in and --udp are mutually exclusive",
                  file=sys.stderr)
            return 2
        stats = sess.rx_live(args.udp, audio_out=args.audio_out,
                             payload_out=args.payload_out,
                             idle_timeout_s=args.idle_timeout,
                             input_rate=args.rate,
                             equalize=args.equalize)
        print(json.dumps(stats))
        return 0
    if not paths:
        print("error: one of --in or --udp is required", file=sys.stderr)
        return 2
    stats = sess.rx_file(paths[0] if len(paths) == 1 else paths,
                         payload_out=args.payload_out,
                         audio_out=args.audio_out, input_rate=args.rate,
                         resume_state=args.resume_state,
                         save_state=args.save_state,
                         equalize=args.equalize,
                         packet_out=args.packet_out)
    print(json.dumps(stats))
    return 0


def cmd_duplex(args) -> int:
    sess, _ = _mk_session(args)
    stats = sess.duplex_file(
        getattr(args, "in"), args.out, audio_in=args.audio,
        payload_in=args.payload, audio_out=args.audio_out,
        payload_out=args.payload_out, n_frames=args.frames)
    print(json.dumps(stats))
    return 0


def cmd_gateway(args) -> int:
    sess, _ = _mk_session(args)
    if args.reflector:
        sess.connect(args.reflector, args.module, port=args.port,
                     bind_port=args.bind_port)
    try:
        if args.live:
            stats = sess.gateway_run_live(
                getattr(args, "in"), args.out,
                chunk_blocks=args.chunk_blocks)
        else:
            stats = sess.gateway_run_file(getattr(args, "in"), args.out)
    finally:
        sess.disconnect()
    print(json.dumps(stats))
    return 0


def cmd_bert(args) -> int:
    import jax
    import numpy as np

    from ..pipeline import loopback

    errors, counted = loopback.bert_loopback(
        jax.random.PRNGKey(args.seed), batch=args.channels,
        n_frames=args.frames, snr_db=float(args.snr))
    e = int(np.sum(np.asarray(errors)))
    n = int(np.sum(np.asarray(counted)))
    print(json.dumps({
        "channels": args.channels, "frames": args.frames,
        "snr_db": args.snr, "bits": n, "errors": e,
        "ber": (e / n) if n else None,
    }))
    return 0


def cmd_sweep(args) -> int:
    import jax

    from ..pipeline import ber_sweep

    snrs = [args.snr_min + i * args.snr_step for i in range(args.points)]
    if args.pod:
        # the mesh-sharded sweep (BASELINE config 5 as one program):
        # TX + per-channel-keyed AWGN + full RX + device-side PRBS
        # accounting inside shard_map, counters psum'd across the mesh
        import jax.numpy as jnp
        import numpy as np

        from ..mesh import sharding

        mesh = sharding.make_mesh()
        ndev = mesh.devices.size
        # channels-per-point rounded up to a multiple of the mesh so
        # every point has the same width and the batch shards evenly
        cpp = max(1, -(-args.channels // args.points))
        cpp += (-cpp) % ndev
        b = args.points * cpp
        keys = jax.random.split(jax.random.PRNGKey(args.seed), b)
        snr_vec = jnp.asarray(
            np.repeat(np.asarray(snrs, np.float32), cpp))
        err, bits, uns, frames, totals = ber_sweep.pod_bert_sweep(
            mesh, keys, snr_vec, args.frames)
        per = b // args.points
        out = []
        for i, s in enumerate(snrs):
            nb = int(np.asarray(bits)[i * per:(i + 1) * per].sum())
            ne = int(np.asarray(err)[i * per:(i + 1) * per].sum())
            nf = int(np.asarray(frames)[i * per:(i + 1) * per].sum())
            out.append({"snr_db": s, "bits": nb, "bit_errors": ne,
                        "ber": (ne / nb) if nb else None,
                        "frames_recovered": nf,
                        "frames_sent": args.frames * per})
        print(json.dumps({
            "mesh_devices": ndev, "channels": b,
            "totals_psum": [int(x) for x in np.asarray(totals)],
            "points": out}))
        return 0
    points = ber_sweep.ber_sweep(
        jax.random.PRNGKey(args.seed),
        snr_points_db=snrs,
        channels_per_point=args.channels, n_frames=args.frames,
        freq_offset_hz=args.freq_offset, drift_ppm=args.drift_ppm)
    print(json.dumps(ber_sweep.sweep_to_json(points)))
    return 0


def cmd_repl(args) -> int:
    sess, mmi = _mk_session(args)
    if getattr(args, "live", False):
        from .curses_view import live_screen

        if getattr(args, "udp", None):
            # live modem behind the screen: rx_live runs forever in a
            # worker thread, updating the shared DB (rssi, in_frame,
            # callsigns) that the curses view renders 4x/s -- the
            # reference's gui_update-from-the-rx-chain arrangement
            # (gui.cpp:157-190 fed from radio_rssi_update)
            import threading

            stop = threading.Event()
            worker = threading.Thread(
                target=sess.rx_live,
                args=(args.udp,),
                kwargs={"forever": True, "stop": stop,
                        "idle_timeout_s": 0.5},
                daemon=True)
            worker.start()
            try:
                live_screen(mmi, mmi.db)
            finally:
                stop.set()
                worker.join(timeout=3.0)
        else:
            live_screen(mmi, mmi.db)
        sess.disconnect()
        return 0
    print(render(mmi.db, signal=mmi.db.rssi))
    print("m17> ", end="", flush=True)
    for line in sys.stdin:
        resp = mmi.parse(line.strip()) if line.strip() else "OK"
        print(resp)
        print(render(mmi.db, signal=mmi.db.rssi))
        print("m17> ", end="", flush=True)
    sess.disconnect()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="m17-sdr")
    p.add_argument("-c", "--config", help="MMI command file (config.txt)")
    p.add_argument("--platform", choices=["default", "cpu", "gpu"],
                   default="default",
                   help="JAX backend override (same as JAX_PLATFORMS); "
                        "default lets JAX pick the GPU when it has one")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tx", help="encode a voice session to an IQ file")
    t.add_argument("--out", required=True)
    t.add_argument("--audio", help="8 kHz s16le PCM input")
    t.add_argument("--payload", help="raw 16-byte-frame payload input")
    t.add_argument("--packet", help="send this file's bytes as an M17 "
                                    "packet-mode superframe")
    t.add_argument("--bert", type=int,
                   help="send N PRBS9 BERT frames (on-air bit-error "
                        "test; rx reports the measured BER)")
    t.add_argument("--frames", type=int, default=None,
                   help="stream frames to send (default 10 for a "
                        "pre-built session; --live default is "
                        "open-ended, 0 also means open-ended)")
    t.add_argument("--src", default="N0CALL")
    t.add_argument("--dest", default="BROADCAST")
    t.add_argument("--gps-nmea", dest="gps_nmea",
                   help="NMEA file/device; embeds the fix in the LSF META")
    t.add_argument("--rate", type=int, default=48_000,
                   help="IQ sample rate: 48000 (Lime) or 384000 (Pluto)")
    t.add_argument("--udp-out", dest="udp_out", metavar="HOST:PORT",
                   help="also stream the capture as live IQ block "
                        "datagrams (feeds a running `rx --udp`)")
    t.add_argument("--pace", action="store_true",
                   help="with --udp-out: send at real time (40 ms per "
                        "block) instead of as fast as possible")
    t.add_argument("--live", action="store_true",
                   help="open-ended live TX: stream frames as mic audio "
                        "arrives (--audio device for a real microphone) "
                        "instead of pre-building the session; --frames "
                        "bounds it, 0 = until the mic ends")
    t.set_defaults(fn=cmd_tx)

    r = sub.add_parser("rx", help="decode IQ capture file(s) or a "
                                  "live UDP IQ stream")
    r.add_argument("--in", action="append",
                   help="IQ capture; repeat for N independent channels "
                        "decoded in one batch (per-channel stats + "
                        ".ch<N>-suffixed outputs)")
    r.add_argument("--udp", type=int, metavar="PORT",
                   help="LIVE receive: listen for int16 IQ block "
                        "datagrams on this port and decode mid-stream "
                        "(the reference's real-time RX loop)")
    r.add_argument("--idle-timeout", dest="idle_timeout", type=float,
                   default=2.0,
                   help="end a --udp session after this many seconds "
                        "of socket silence")
    r.add_argument("--payload-out", dest="payload_out")
    r.add_argument("--audio-out", dest="audio_out",
                   help="decoded voice: a .wav/.raw path, or "
                        "pulse/alsa/default to PLAY on a device")
    r.add_argument("--packet-out", dest="packet_out",
                   help="write a reassembled, CRC-verified packet here")
    r.add_argument("--src", default="N0CALL")
    r.add_argument("--rate", type=int, default=48_000,
                   help="IQ sample rate: 48000 (Lime) or 384000 (Pluto)")
    r.add_argument("--equalize", nargs="?", const="on", default="auto",
                   choices=["off", "on", "auto"],
                   help="adaptive multipath equalizer stage: auto "
                        "(default) arms per channel when the eye-"
                        "closure detector sees ISI; on forces it; "
                        "off disables it")
    r.add_argument("--resume-state", dest="resume_state",
                   help="npz checkpoint to resume the modem state from")
    r.add_argument("--save-state", dest="save_state",
                   help="write the final modem state to this npz")
    r.set_defaults(fn=cmd_rx)

    d = sub.add_parser(
        "duplex", help="full-duplex: decode one IQ file while "
                       "transmitting another (radio_duplex / MMI td)")
    d.add_argument("--in", required=True, help="IQ capture to decode")
    d.add_argument("--out", required=True, help="IQ file to transmit")
    d.add_argument("--audio", help="8 kHz s16le PCM mic input")
    d.add_argument("--payload", help="raw 16-byte-frame payload input")
    d.add_argument("--payload-out", dest="payload_out")
    d.add_argument("--audio-out", dest="audio_out")
    d.add_argument("--frames", type=int, default=10)
    d.add_argument("--src", default="N0CALL")
    d.add_argument("--dest", default="BROADCAST")
    d.set_defaults(fn=cmd_duplex)

    g = sub.add_parser(
        "gateway", help="DRTODN radio<->reflector gateway over file "
                        "backends (m17_txrx_net_thread)")
    g.add_argument("--in", required=True, help="RF IQ capture to decode")
    g.add_argument("--out", required=True, help="RF IQ output for net->RF")
    g.add_argument("--reflector", help="reflector host/IP (name via "
                                       "io.hosts directory)")
    g.add_argument("--module", default="A")
    g.add_argument("--port", type=int, default=None,
                   help="explicit reflector port (default: the "
                        "directory entry's port, else 17000)")
    g.add_argument("--bind-port", dest="bind_port", type=int, default=0)
    g.add_argument("--live", action="store_true",
                   help="continuous alternating RX/TX loop with the "
                        "jitter queue filling mid-session; default is "
                        "the one-pass batch gateway")
    g.add_argument("--chunk-blocks", dest="chunk_blocks", type=int,
                   default=5)
    g.add_argument("--src", default="N0CALL")
    g.set_defaults(fn=cmd_gateway)

    b = sub.add_parser("bert", help="PRBS9 BER loopback measurement")
    b.add_argument("--channels", type=int, default=8)
    b.add_argument("--frames", type=int, default=25)
    b.add_argument("--snr", type=float, default=30.0)
    b.add_argument("--seed", type=int, default=0)
    b.set_defaults(fn=cmd_bert)

    s = sub.add_parser("sweep", help="BER-vs-SNR sweep (one batched run)")
    s.add_argument("--snr-min", dest="snr_min", type=float, default=0.0)
    s.add_argument("--snr-step", dest="snr_step", type=float, default=1.0)
    s.add_argument("--points", type=int, default=13)
    s.add_argument("--channels", type=int, default=16,
                   help="channels per SNR point")
    s.add_argument("--frames", type=int, default=20)
    s.add_argument("--freq-offset", dest="freq_offset", type=float, default=0.0)
    s.add_argument("--drift-ppm", dest="drift_ppm", type=float, default=0.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--pod", action="store_true",
                   help="run the sweep sharded over the device mesh "
                        "with psum'd counters (BASELINE config 5; use "
                        "XLA_FLAGS=--xla_force_host_platform_device_"
                        "count=N --platform cpu for a virtual mesh)")
    s.set_defaults(fn=cmd_sweep)

    i = sub.add_parser("repl", help="interactive MMI")
    i.add_argument("--live", action="store_true",
                   help="curses status screen that redraws in place "
                        "(gui.cpp:115-229); default is line mode")
    i.add_argument("--udp", type=int, metavar="PORT",
                   help="with --live: run a live UDP IQ receiver "
                        "behind the screen; the RSSI bar and session "
                        "fields track the incoming signal")
    i.set_defaults(fn=cmd_repl)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax

    from ..compile_cache import enable_compile_cache

    if args.platform != "default":
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
