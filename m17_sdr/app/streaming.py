"""Device-resident streaming RX session.

The reference's real-time loop moves one 40 ms block per iteration
between the radio and the DSP (m17_tx_rx.cpp:160-170).  A literal
translation -- one device dispatch plus device->host reads per block --
pays a dispatch and a transfer round trip every 40 ms, so the
streaming session is built around four rules:

  1. samples cross host->device in large chunks (CHUNK_BLOCKS x 1920
     int16 samples per dispatch), not per 40 ms block;
  2. all modem state (RxSessionState + the Pluto-rate FIR tail) stays
     on device between chunks;
  3. decoded outputs accumulate ON DEVICE and cross to the host exactly
     once, in finish();
  4. host->device upload is DOUBLE-BUFFERED through a dedicated
     uploader thread: chunk N+1's jax.device_put runs in that thread
     while the main thread dispatches chunk N's compute
     asynchronously -- the transfer of the next chunk rides under the
     device's work on the current one instead of serializing ahead of
     it.

Host-side sample transport runs through the native SampleRing
(runtime/m17_runtime.cpp) between the producer thread that drains the
sample source and the consumer loop that batches chunks for dispatch --
the same producer/consumer decoupling the reference gets from its
buffer pool between the udp and txrx threads (buffers.cpp:13-17).
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading
from typing import Iterator, NamedTuple

import numpy as np

from ..spec.constants import BLOCK_SAMPLES

DEFAULT_CHUNK_BLOCKS = 25            # 1 s of signal per device dispatch


class StreamChunkState(NamedTuple):
    """Everything carried on device between chunk dispatches."""

    rx: "RxSessionState"             # modem session state
    dec_tail: "jnp.ndarray"          # [B, 2, 30] Pluto-rate FIR history


@functools.lru_cache(maxsize=None)
def _chunk_fn(afc: bool, factor: int, equalize: bool = False):
    """Build the jitted whole-chunk processor for one (afc, rate) pair.

    wire int16 [B, NBLK, T_in, 2] -> (RxBlockOutput stacked on axis 1,
    new StreamChunkState).  Covers the per-block chain
    radio_receive_samples -> m17_dsp_rx -> ... -> m17_rx_parse
    (SURVEY.md section 3.2) for NBLK blocks in ONE dispatch.
    """
    import jax
    import jax.numpy as jnp

    from ..dsp import resample
    from ..dsp.discriminator import scale_int16
    from ..pipeline.rx import rx_stream

    taps = resample.pluto_dec_taps()

    @jax.jit
    def run(wire, state: StreamChunkState):
        b, nblk, t_in, _ = wire.shape
        iq = scale_int16(wire)                      # [B, NBLK, 2, T_in]
        dec_tail = state.dec_tail
        if factor > 1:
            flat = jnp.moveaxis(iq, 1, 2).reshape(b, 2, nblk * t_in)
            flat, dec_tail = resample.fir_decimate(
                flat, jnp.asarray(taps), dec_tail, factor=factor)
            t48 = t_in // factor
            iq = jnp.moveaxis(flat.reshape(b, 2, nblk, t48), 2, 1)
        out, rx = rx_stream(iq, state.rx, afc_enabled=afc,
                            equalize=equalize)
        return out, StreamChunkState(rx=rx, dec_tail=dec_tail)

    return run


class StreamingRx:
    """Streaming receiver: feed int16 IQ blocks, collect results once.

    Usage:
        srx = StreamingRx(input_rate=..., afc=...)
        srx.run(source)           # or: feed_block(...) repeatedly
        outs, state, nblk = srx.finish()
    """

    def __init__(self, batch: int = 1, input_rate: int = 48_000,
                 afc: bool = False, equalize: bool = False,
                 chunk_blocks: int = DEFAULT_CHUNK_BLOCKS,
                 upload_streams: int = 1):
        factor = input_rate // 48_000
        if input_rate != factor * 48_000 or factor not in (1, 8):
            raise ValueError(f"unsupported input rate {input_rate}")
        import jax.numpy as jnp

        from ..dsp import resample
        from ..pipeline.rx import RxSessionState

        self.batch = batch
        self.factor = factor
        self.afc = afc
        self.chunk_blocks = chunk_blocks
        self.block_in = BLOCK_SAMPLES * factor       # input samples/block
        self._fn = _chunk_fn(afc, factor, equalize)
        self._state = StreamChunkState(
            rx=RxSessionState.init(batch),
            dec_tail=resample.decimate_init(batch))
        self._pending: list[np.ndarray] = []         # [B, T_in, 2] int16
        self._outs = []                              # device RxBlockOutputs
        self._real_blocks: list[int] = []            # per chunk
        self._staged: list[tuple] = []               # (upload future, nblk)
        self._upload_depth = max(1, upload_streams)
        self._uploader = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._upload_depth,
            thread_name_prefix="m17-upload")
        self._jnp = jnp

    # ------------------------------------------------------------------
    def feed_block(self, wire_block: np.ndarray) -> None:
        """One [B, T_in, 2] (or [T_in, 2] for batch 1) int16 IQ block."""
        if getattr(self, "_finished", False):
            raise RuntimeError(
                "StreamingRx.finish() was already called; the engine is "
                "single-use (its uploader pool is shut down) -- create a "
                "new StreamingRx for another session")
        if wire_block.ndim == 2:
            wire_block = wire_block[None]
        assert wire_block.shape == (self.batch, self.block_in, 2)
        self._pending.append(wire_block)
        if len(self._pending) == self.chunk_blocks:
            pend, self._pending = self._pending, []
            self._dispatch(pend)

    def _dispatch(self, blocks: list[np.ndarray]) -> None:
        """Stage this chunk's upload in the uploader pool; compute the
        oldest staged chunk once the pipeline is full.

        The transfer runs in the uploader pool while the main thread
        dispatches compute asynchronously; chunk ORDER is preserved
        because compute always consumes the oldest staged future.  The
        pipeline tail is settled by _compute_staged() from
        flush_pending()/finish()."""
        arr = np.stack(blocks, axis=1)
        fut = self._uploader.submit(self._jnp.asarray, arr)
        self._staged.append((fut, len(blocks)))
        while len(self._staged) > self._upload_depth:
            self._compute_one()

    def _compute_one(self) -> None:
        fut, n = self._staged.pop(0)
        out, self._state = self._fn(fut.result(), self._state)
        self._outs.append(out)
        self._real_blocks.append(n)

    def _compute_staged(self) -> None:
        while self._staged:
            self._compute_one()

    def flush_pending(self) -> None:
        """Dispatch buffered blocks EXACTLY (no zero padding -- pad
        blocks would pollute the carried state: RSSI decay, DC, framer).
        The tail is decomposed into power-of-two sub-chunks so at most
        log2(chunk_blocks) extra shapes ever compile, and those shapes
        recur across captures (jit + persistent cache friendly)."""
        pend, self._pending = self._pending, []
        while pend:
            n = 1 << (len(pend).bit_length() - 1)    # largest 2^k <= len
            self._dispatch(pend[:n])
            pend = pend[n:]
        self._compute_staged()

    # ------------------------------------------------------------------
    def checkpoint(self, path: str) -> None:
        """Persist the full modem carry (RxSessionState + FIR tail) so a
        later StreamingRx can resume bit-identically (SURVEY.md 5.4)."""
        from . import checkpoint as ckpt

        self.flush_pending()
        ckpt.save_state(path, self._state)

    def resume(self, path: str) -> None:
        """Restore carry state saved by checkpoint()."""
        from . import checkpoint as ckpt

        assert (not self._outs and not self._pending
                and not self._staged), \
            "resume() must precede any processing"
        self._state, _ = ckpt.load_state(path, self._state)

    # ------------------------------------------------------------------
    def run(self, raw_blocks: Iterator[np.ndarray],
            use_ring: bool = True) -> None:
        """Drain a block iterator through the native SampleRing.

        A producer thread pushes raw int16 wire blocks into the ring;
        this (consumer) thread pops, batches, and dispatches chunks --
        I/O latency overlaps device compute exactly like the
        reference's buffer pool decouples its udp and txrx threads.
        """
        if not use_ring:
            for blk in raw_blocks:
                self.feed_block(blk)
            return

        from ..runtime import SampleRing

        block_bytes = self.batch * self.block_in * 2 * 2
        # ring depth targets a byte budget, not a fixed block count: at
        # large batch x Pluto rate a 64-deep ring would be GBs of host
        # RAM for buffering that only needs to cover I/O jitter
        depth = max(4, min(64, (256 << 20) // max(block_bytes, 1)))
        ring = SampleRing(block_bytes, capacity_pow2=depth)
        done = threading.Event()
        producer_error: list[BaseException] = []

        def producer() -> None:
            try:
                for blk in raw_blocks:
                    data = np.ascontiguousarray(blk, dtype="<i2").tobytes()
                    while not ring.push(data):      # backpressure
                        if done.is_set():
                            return
                        threading.Event().wait(0.001)
            except BaseException as e:   # surfaced to run()'s caller:
                producer_error.append(e)  # a truncated capture must not
            finally:                      # decode as a "successful" run
                done.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                data = ring.pop()
                if data is None:
                    if done.is_set():
                        data = ring.pop()    # drain race: check once more
                        if data is None:
                            break
                    else:
                        threading.Event().wait(0.001)
                        continue
                blk = np.frombuffer(data, dtype="<i2").reshape(
                    self.batch, self.block_in, 2)
                self.feed_block(blk)
        finally:
            done.set()
            t.join(timeout=5.0)
            # ring_destroy frees the block array; a producer still
            # blocked inside raw_blocks (stalled source) would then
            # push into freed memory.  Leak the ring instead -- the
            # daemon thread dies with the process either way.
            if not t.is_alive():
                ring.close()
        if producer_error:
            raise RuntimeError(
                "sample producer failed mid-stream; the capture is "
                "truncated") from producer_error[0]

    # ------------------------------------------------------------------
    def finish(self):
        """Flush pending blocks and do the session's ONE device->host
        transfer.  Returns (host RxBlockOutput stacked over all real
        blocks on axis 1, host RxSessionState, n_blocks).  Terminal:
        the uploader thread is shut down (one OS thread per session
        would otherwise accumulate in long-lived repl/gateway
        processes)."""
        import jax

        self.flush_pending()
        self._finished = True
        self._uploader.shutdown(wait=False)
        n_blocks = sum(self._real_blocks)
        if not self._outs:
            return None, jax.device_get(self._state.rx), 0
        host_outs, host_rx = jax.device_get((self._outs, self._state.rx))
        out = jax.tree.map(
            lambda *xs: np.concatenate(xs, axis=1)
            if xs[0].ndim >= 2 else xs[-1],
            *host_outs)
        return out, host_rx, n_blocks


def wire_block_iter(path: str, block_in: int) -> Iterator[np.ndarray]:
    """Raw int16 IQ wire blocks [T_in, 2] from a capture file (the
    radio_receive_samples contract, radio.cpp:157-177)."""
    data = np.fromfile(path, dtype="<i2")
    n = (len(data) // (block_in * 2)) * block_in * 2
    for pos in range(0, n, block_in * 2):
        yield data[pos: pos + block_in * 2].reshape(block_in, 2)


def batch_wire_block_iter(paths: list[str],
                          block_in: int) -> Iterator[np.ndarray]:
    """[B, T_in, 2] int16 wire blocks from B parallel capture files.

    The framework's one-channel-per-file analog of BatchFileSource
    (io/sources.py): channels shorter than the longest capture are
    zero-padded (idle carrier), and the partial tail block of the
    longest capture is dropped, exactly like the single-file iterator.
    """
    datas = [np.fromfile(p, dtype="<i2") for p in paths]
    per_blk = block_in * 2
    nblk = max(len(d) for d in datas) // per_blk
    for pos in range(0, nblk * per_blk, per_blk):
        blk = np.zeros((len(datas), block_in, 2), np.int16)
        for i, d in enumerate(datas):
            seg = d[pos: pos + per_blk]
            blk[i, : len(seg) // 2] = seg[: (len(seg) // 2) * 2].reshape(-1, 2)
        yield blk
