#!/usr/bin/env python
"""BASELINE config 5 as ONE program: the pod-scale BER sweep.

4096 channels over 16 SNR points spanning the chain's actual RF
waterfall (8-20 dB; the FM chain's frame recovery runs ~0 -> ~1 over
14-18 dB, tests/test_ber_sweep.py), sharded over an
8-device mesh on the channel axis, with TX synthesis, per-channel-keyed
AWGN, the full RX pipeline, AND the PRBS error accounting all on
device; the pod-wide counters cross the mesh in one psum (the
all_reduce SURVEY.md section 5.8 maps to this config).  The same
program then runs unsharded and the artifact asserts bit-identical
per-channel counters -- the distributed guarantee of SURVEY section 4.

Writes SWEEP_POD_r5.json.  Runs on the virtual 8-device CPU mesh
(xla_force_host_platform_device_count); on real hardware the same
Mesh spans real chips.

Usage: python tools/sweep_pod.py [--channels 4096] [--frames 20]
"""

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=4096)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--points", type=int, default=16)
    ap.add_argument("--snr-min", type=float, default=8.0)
    ap.add_argument("--snr-max", type=float, default=20.0)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-unsharded", action="store_true")
    ap.add_argument("--out", default="SWEEP_POD_r5.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from m17_sdr.mesh import sharding
    from m17_sdr.pipeline import ber_sweep as bs
    from m17_sdr.spec.constants import BERT_BITS

    b = args.channels
    assert b % args.points == 0 and b % args.devices == 0
    cpp = b // args.points
    snr_pts = np.linspace(args.snr_min, args.snr_max,
                          args.points).astype(np.float32)
    snr = jnp.asarray(np.repeat(snr_pts, cpp))
    keys = jax.random.split(jax.random.PRNGKey(args.seed), b)

    mesh = sharding.make_mesh(args.devices)
    t0 = time.time()
    es, bss, us, fs, totals = jax.block_until_ready(
        bs.pod_bert_sweep(mesh, keys, snr, args.frames))
    t_shard = time.time() - t0

    doc = {
        "config": "BASELINE config 5: pod-scale BERT BER sweep "
                  f"{args.snr_min:g}-{args.snr_max:g} dB over the "
                  "chain's RF waterfall as one sharded program",
        "channels": b, "snr_points": args.points,
        "channels_per_point": cpp, "frames_per_channel": args.frames,
        "mesh": {"devices": args.devices, "axis": "ch",
                 "backend": jax.default_backend(),
                 "collective": "psum of [errors, bits, unsynced, "
                               "frames] counters"},
        "sharded_elapsed_s": round(t_shard, 1),
        "totals_psum": [int(x) for x in np.asarray(totals)],
    }

    if not args.skip_unsharded:
        t0 = time.time()
        eu, bu, uu, fu = jax.block_until_ready(
            bs.bert_sweep_counts(keys, snr, args.frames))
        doc["unsharded_elapsed_s"] = round(time.time() - t0, 1)
        eq = (np.array_equal(np.asarray(es), np.asarray(eu))
              and np.array_equal(np.asarray(bss), np.asarray(bu))
              and np.array_equal(np.asarray(us), np.asarray(uu))
              and np.array_equal(np.asarray(fs), np.asarray(fu)))
        doc["sharded_equals_unsharded"] = bool(eq)
        doc["totals_equal_sums"] = bool(
            [int(x) for x in np.asarray(totals)]
            == [int(np.asarray(es).sum()), int(np.asarray(bss).sum()),
                int(np.asarray(us).sum()), int(np.asarray(fs).sum())])

    err = np.asarray(es).reshape(args.points, cpp)
    bits = np.asarray(bss).reshape(args.points, cpp)
    frames = np.asarray(fs).reshape(args.points, cpp)
    curve = []
    for i, s in enumerate(snr_pts):
        nb = int(bits[i].sum())
        curve.append({
            "snr_db": float(s),
            "bit_errors": int(err[i].sum()), "bits": nb,
            "ber": round(err[i].sum() / nb, 6) if nb else 1.0,
            "frames_recovered": int(frames[i].sum()),
            "frames_sent": args.frames * cpp,
            "frame_recovery": round(
                frames[i].sum() / (args.frames * cpp), 4),
        })
    doc["curve"] = curve
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    for row in curve:
        print(f"snr={row['snr_db']:5.2f} ber={row['ber']:.5f} "
              f"recovery={row['frame_recovery']:.3f}")
    print("sharded==unsharded:", doc.get("sharded_equals_unsharded"),
          "->", args.out)


if __name__ == "__main__":
    main()
