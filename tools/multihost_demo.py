#!/usr/bin/env python
"""Multi-controller (N>=2 hosts) demonstration (VERDICT r4 weak #8).

BASELINE's scale target names N>=2 *hosts*.  This environment has one
machine, so the closest faithful demonstration is JAX's actual
multi-controller runtime: TWO separate `jax.distributed`-initialized
processes on localhost (CPU backend, 4 virtual devices each = one
8-device global mesh), channels sharded ACROSS the processes, the
pod-wide counters reduced by a psum that crosses the process
boundary over the distributed runtime's wire (the DCN path a real
multi-host pod uses; SURVEY.md section 5.8).  This exercises code the
single-process virtual mesh never touches: distributed service
init/handshake, global-array assembly from process-local shards
(jax.make_array_from_callback), cross-process collectives, and
multihost_utils.process_allgather.  The workers force the CPU
platform: two JAX processes must not share one GPU.

The parent then runs the SAME sweep unsharded in-process and asserts
the distributed run's per-channel counters and psum'd totals are
bit-identical (per-channel-keyed noise makes the program placement-
invariant).  Writes MULTIHOST_r5.json.

Usage: python tools/multihost_demo.py [--channels 128] [--frames 8]
       (spawns itself twice with --worker N)
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

NPROC = 2
LOCAL_DEVICES = 4


def worker(args) -> None:
    """One controller process: init distributed, run the sharded sweep
    over the GLOBAL mesh, report this process's view."""
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=NPROC, process_id=args.worker)

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from m17_sdr.pipeline import ber_sweep as bs

    assert jax.process_count() == NPROC
    assert len(jax.devices()) == NPROC * LOCAL_DEVICES
    assert len(jax.local_devices()) == LOCAL_DEVICES

    b = args.channels
    points = np.linspace(args.snr_min, args.snr_max,
                         args.points).astype(np.float32)
    cpp = b // args.points
    snr_np = np.repeat(points, cpp)
    keys_np = np.asarray(
        jax.random.split(jax.random.PRNGKey(args.seed), b))

    # one GLOBAL mesh over all processes' devices; channels sharded
    # across it, so each process materializes only its own half of the
    # sweep (the multi-host ingest pattern: every host feeds its local
    # shard, jax assembles the global array)
    mesh = Mesh(np.array(jax.devices()), ("ch",))
    sh = NamedSharding(mesh, P("ch"))

    def garray(host_np):
        return jax.make_array_from_callback(
            host_np.shape, sh, lambda idx: host_np[idx])

    keys = garray(keys_np)
    snr = garray(snr_np)

    t0 = time.time()
    err, bits, uns, frames, totals = bs.pod_bert_sweep(
        mesh, keys, snr, args.frames)
    # the psum crossed the process boundary; every process holds the
    # same replicated totals
    totals_here = np.asarray(totals)
    # gather the sharded per-channel counters to every process over
    # the distributed runtime (the cross-process all_gather path)
    err_all = multihost_utils.process_allgather(err, tiled=True)
    bits_all = multihost_utils.process_allgather(bits, tiled=True)
    uns_all = multihost_utils.process_allgather(uns, tiled=True)
    frames_all = multihost_utils.process_allgather(frames, tiled=True)
    elapsed = time.time() - t0

    out = {
        "process_id": args.worker,
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "totals_psum": [int(x) for x in totals_here],
        "elapsed_s": round(elapsed, 1),
        "err": [int(x) for x in err_all],
        "bits": [int(x) for x in bits_all],
        "uns": [int(x) for x in uns_all],
        "frames": [int(x) for x in frames_all],
    }
    with open(args.scratch / f"worker{args.worker}.json", "w") as f:
        json.dump(out, f)
    jax.distributed.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--points", type=int, default=8)
    ap.add_argument("--snr-min", type=float, default=8.0)
    ap.add_argument("--snr-max", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port", type=int, default=47123)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--scratch", type=pathlib.Path,
                    default=pathlib.Path("/tmp/m17_multihost"))
    ap.add_argument("--out", default="MULTIHOST_r5.json")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    assert args.channels % args.points == 0
    assert args.channels % (NPROC * LOCAL_DEVICES) == 0

    if args.worker is not None:
        worker(args)
        return

    args.scratch.mkdir(parents=True, exist_ok=True)
    for n in range(NPROC):
        p = args.scratch / f"worker{n}.json"
        if p.exists():
            p.unlink()

    # spawn the two controller processes
    base = [sys.executable, str(pathlib.Path(__file__).resolve()),
            "--channels", str(args.channels), "--frames", str(args.frames),
            "--points", str(args.points), "--snr-min", str(args.snr_min),
            "--snr-max", str(args.snr_max), "--seed", str(args.seed),
            "--port", str(args.port), "--scratch", str(args.scratch)]
    procs = [subprocess.Popen(base + ["--worker", str(n)],
                              cwd=str(REPO)) for n in range(NPROC)]
    t0 = time.time()
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(10.0, args.timeout
                                          - (time.time() - t0))))
    finally:
        # a worker that died pre-handshake leaves its peer blocked in
        # jax.distributed.initialize forever -- never orphan it (it
        # would also hold the coordinator port for the next run)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10.0)
    assert all(rc == 0 for rc in rcs), f"worker exit codes {rcs}"

    views = []
    for n in range(NPROC):
        with open(args.scratch / f"worker{n}.json") as f:
            views.append(json.load(f))

    # every process must hold the identical psum'd totals and the
    # identical gathered per-channel counters
    agree = all(v["totals_psum"] == views[0]["totals_psum"]
                and v["err"] == views[0]["err"]
                and v["bits"] == views[0]["bits"]
                and v["uns"] == views[0]["uns"]
                and v["frames"] == views[0]["frames"] for v in views)

    # unsharded single-process reference (no distributed runtime)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    from m17_sdr.pipeline import ber_sweep as bs

    points = np.linspace(args.snr_min, args.snr_max,
                         args.points).astype(np.float32)
    cpp = args.channels // args.points
    snr = jnp.asarray(np.repeat(points, cpp))
    keys = jax.random.split(jax.random.PRNGKey(args.seed), args.channels)
    eu, bu, uu, fu = jax.block_until_ready(
        bs.bert_sweep_counts(keys, snr, args.frames))
    ref = {"err": [int(x) for x in np.asarray(eu)],
           "bits": [int(x) for x in np.asarray(bu)],
           "uns": [int(x) for x in np.asarray(uu)],
           "frames": [int(x) for x in np.asarray(fu)]}
    ref_totals = [sum(ref["err"]), sum(ref["bits"]),
                  sum(ref["uns"]), sum(ref["frames"])]

    match = all(views[0][k] == ref[k] for k in
                ("err", "bits", "uns", "frames"))
    totals_match = views[0]["totals_psum"] == ref_totals

    doc = {
        "what": "two jax.distributed controller processes on localhost, "
                "channels sharded across processes, psum'd counters "
                "crossing the process boundary (the N>=2-host DCN "
                "code path this environment can exercise)",
        "processes": NPROC,
        "local_devices_per_process": LOCAL_DEVICES,
        "global_devices": views[0]["global_devices"],
        "channels": args.channels, "frames": args.frames,
        "snr_points": args.points,
        "snr_range_db": [args.snr_min, args.snr_max],
        "totals_psum": views[0]["totals_psum"],
        "worker_elapsed_s": [v["elapsed_s"] for v in views],
        "processes_agree": bool(agree),
        "distributed_equals_single_process": bool(match),
        "totals_equal_single_process": bool(totals_match),
        "ok": bool(agree and match and totals_match),
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({k: doc[k] for k in
                      ("processes_agree",
                       "distributed_equals_single_process",
                       "totals_equal_single_process", "ok")}))
    if not doc["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
