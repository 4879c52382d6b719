#!/usr/bin/env python
"""IQ-domain BER parity artifact (VERDICT r4 next-round #3).

Runs identical 48 kHz int16 IQ -- AWGN across the FM chain's RF
waterfall, plus a carrier-offset config -- through BOTH complete RX
chains (the in-place-compiled reference incl. its m17_dsp_rx front
end, and this framework's rx_stream incl. dsp/discriminator.py), and
applies the same agreement predicates as the soft-domain harness.
Writes BER_PARITY_IQ_r5.json.

Usage: python tools/ber_parity_iq.py [--channels 16] [--frames 16]
"""

import argparse
import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offset-hz", type=float, default=300.0)
    ap.add_argument("--out", default="BER_PARITY_IQ_r5.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from m17_sdr.pipeline import ber_parity_iq as biq

    # the FM chain's RF waterfall sits at ~13-18 dB (test_ber_sweep);
    # span it plus clear-channel headroom
    snrs = [13.0, 14.0, 15.0, 16.0, 18.0, 20.0, 24.0]
    doc = {
        "methodology": (
            "shared-IQ: identical 48 kHz int16 interleaved IQ decoded "
            "by the reference's COMPLETE chain (m17_dsp_rx front end: "
            "scale/limit/quadrature-discriminator/decimate/DC, then "
            "timing+framer+parse; one process per channel) and by this "
            "framework's full rx_stream -- the last untested seam "
            "(the soft-domain harness enters post-discriminator)"),
        "channels": args.channels, "frames": args.frames,
        "min_fn_scored": 8,
        "configs": {},
    }
    all_ok = True
    for name, off in (("awgn", 0.0),
                      (f"offset{args.offset_hz:g}Hz", args.offset_hz)):
        with tempfile.TemporaryDirectory() as td:
            pts = biq.run_parity_iq(
                snrs, args.channels, args.frames, td,
                seed=args.seed, freq_offset_hz=off)
        cfg = biq.parity_to_json(pts)
        for p, row in zip(pts, cfg["points"]):
            row["frame_agreement_ok"] = bool(biq.frame_agreement_ok(p))
            row["ber_agreement_ok"] = bool(biq.ber_agreement_ok(p))
            all_ok &= row["frame_agreement_ok"] and row["ber_agreement_ok"]
            rb, jb = p.bers()
            print(f"{name:12s} snr={p.snr_db:5.1f} "
                  f"ref {p.ref[0]:3d}/{p.ref[1]} ber {rb:.5f} | "
                  f"jax {p.jax[0]:3d}/{p.jax[1]} ber {jb:.5f} | "
                  f"ok {row['frame_agreement_ok'] and row['ber_agreement_ok']}")
        doc["configs"][name] = cfg
    doc["all_ok"] = bool(all_ok)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print("all_ok:", all_ok, "->", args.out)


if __name__ == "__main__":
    main()
