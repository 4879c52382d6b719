"""Multi-device tests on the 8-device virtual CPU mesh.

The distributed guarantees (SURVEY.md section 4): N sharded channels
equal N independent runs bit-exactly; overlap-save time splits equal
unsplit processing; warm-up time slabs recover the sequential frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr.mesh import halo, sharding
from m17_sdr.pipeline import loopback, tx as txp
from m17_sdr.pipeline.rx import RxSessionState, rx_stream
from m17_sdr.spec.constants import FT_STREAM

from test_pipeline import _mk_lsf, _payloads

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= NDEV
    return sharding.make_mesh(NDEV)


def _session_iq(b, nf=4, seed=0):
    """Returns planar IQ [B, 2, T]."""
    lsf = _mk_lsf(b)
    pl = _payloads(b, nf, seed)
    dibits = txp.build_voice_session_dibits(lsf, pl)
    iq, _ = txp.dibits_to_iq(dibits)
    return iq, lsf, pl


class TestPodBertSweep:
    def test_sharded_sweep_equals_unsharded(self, mesh):
        """BASELINE config 5 as one program (round-4): the whole BERT
        sweep -- TX, per-channel-keyed AWGN, full RX, device-side PRBS
        accounting -- sharded over the mesh's channel axis must equal
        the unsharded run bit-exactly, and the psum'd totals must
        equal the sums of the per-channel counters."""
        from m17_sdr.pipeline import ber_sweep as bs

        b, nf = 32, 6
        keys = jax.random.split(jax.random.PRNGKey(7), b)
        snr = jnp.asarray(
            np.repeat(np.array([6.0, 30.0], np.float32), b // 2))
        eu, bu, uu, fu = bs.bert_sweep_counts(keys, snr, nf)
        es, bss, us, fs, totals = bs.pod_bert_sweep(mesh, keys, snr, nf)
        np.testing.assert_array_equal(np.asarray(eu), np.asarray(es))
        np.testing.assert_array_equal(np.asarray(bu), np.asarray(bss))
        np.testing.assert_array_equal(np.asarray(uu), np.asarray(us))
        np.testing.assert_array_equal(np.asarray(fu), np.asarray(fs))
        np.testing.assert_array_equal(
            np.asarray(totals),
            [int(eu.sum()), int(bu.sum()), int(uu.sum()), int(fu.sum())])
        # sanity: the 30 dB half actually decodes error-free frames
        assert int(fu[b // 2:].sum()) > 0
        assert int(eu[b // 2:].sum()) == 0


class TestChannelSharding:
    def test_sharded_equals_local(self, mesh):
        b = 16  # 2 channels per device
        iq, lsf, pl = _session_iq(b)
        blocks = loopback._blockify(iq)

        state = RxSessionState.init(b)
        out_ref, state_ref = rx_stream(blocks, state)

        run = sharding.sharded_rx_stream(mesh)
        blocks_sh = sharding.shard_channels(blocks, mesh)
        state_sh = sharding.shard_channels(RxSessionState.init(b), mesh)
        out_sh, state_new, metrics = run(blocks_sh, state_sh)

        np.testing.assert_array_equal(
            np.asarray(out_sh.stream_valid), np.asarray(out_ref.stream_valid))
        np.testing.assert_array_equal(
            np.asarray(out_sh.stream_payload), np.asarray(out_ref.stream_payload))
        np.testing.assert_array_equal(
            np.asarray(state_new.lich_good), np.asarray(state_ref.lich_good))
        # psum'd metrics match local totals
        m = np.asarray(metrics)
        assert m[0] == float(np.sum(np.asarray(state_ref.n_frames)))


class TestOverlapSave:
    def test_fir_split_bitexact(self, mesh):
        rng = np.random.default_rng(0)
        taps = rng.normal(size=31).astype(np.float32)
        x = rng.normal(size=(4, 8 * 256)).astype(np.float32)
        # unsplit causal FIR
        xp = np.pad(x, [(0, 0), (30, 0)])
        idx = np.arange(x.shape[-1])[:, None] + np.arange(31)[None, :]
        want = xp[:, idx] @ taps

        fn = halo.overlap_save_conv(mesh, taps)
        got = fn(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


class TestTimeSlabs:
    def test_warmup_recovers_sequential_frames(self, mesh):
        """Split a long multi-session capture over 8 time slabs; frames
        whose sync lands inside a slab's own span (not the warm-up) must
        match the sequential run."""
        b = 2
        # long capture: several voice sessions back to back
        iqs = []
        pls = []
        for s in range(4):
            iq, lsf, pl = _session_iq(b, nf=4, seed=s)
            iqs.append(np.asarray(iq))
            pls.append(np.asarray(pl))
        iq = jnp.asarray(np.concatenate(iqs, axis=-1))     # [B, 2, T]
        block = 1920
        blocks = loopback._blockify(iq, block)
        nblk = blocks.shape[1] - blocks.shape[1] % NDEV
        blocks = blocks[:, :nblk]

        # sequential reference
        out_ref, _ = rx_stream(blocks, RxSessionState.init(b))
        ref_v = np.asarray(out_ref.stream_valid).reshape(b, -1)
        ref_fn = np.asarray(out_ref.stream_fn).reshape(b, -1)
        ref_pl = np.asarray(out_ref.stream_payload).reshape(b, -1, 16)

        run = halo.time_parallel_rx(mesh, warmup_blocks=3, block=block)
        out_par = run(blocks)
        par_v = np.asarray(out_par.stream_valid).reshape(b, -1)
        par_fn = np.asarray(out_par.stream_fn).reshape(b, -1)
        par_pl = np.asarray(out_par.stream_payload).reshape(b, -1, 16)

        # every (fn, payload) the sequential run recovered must also be
        # recovered by the time-parallel run (sessions are shorter than
        # a slab+warmup, so no frame spans more than the warm-up)
        for ch in range(b):
            ref_set = {(int(f), bytes(p)) for f, p in
                       zip(ref_fn[ch][ref_v[ch]], ref_pl[ch][ref_v[ch]])}
            par_set = {(int(f), bytes(p)) for f, p in
                       zip(par_fn[ch][par_v[ch]], par_pl[ch][par_v[ch]])}
            missing = ref_set - par_set
            assert not missing, f"ch{ch}: missing {len(missing)} frames"

    def test_zero_frame_loss_at_adversarial_alignment(self, mesh):
        """The documented loss bound (halo.time_parallel_rx): with
        warmup_blocks >= 3, EVERY (fn, payload) the sequential run
        recovers is recovered regardless of where sessions sit relative
        to slab boundaries.  Sessions here are long (one spans several
        slabs) and start at deliberately awkward offsets: mid-slab,
        one block before a boundary, exactly on a boundary."""
        b = 1
        block = 1920
        # slabs of 7 blocks on the 8-device mesh -> boundaries at 7k;
        # session starts land mid-slab (blk 2), mid-slab pre-boundary
        # (blk 25), and exactly on a boundary (blk 42)
        offsets_blocks = [2, 5, 8]
        nfs = [12, 3, 6]                # first session spans 2+ slabs
        total_blocks = 56
        sig = np.zeros((b, 2, total_blocks * block), np.float32)
        pls = []
        pos = 0
        for i, (off, nf) in enumerate(zip(offsets_blocks, nfs)):
            iq, _, pl = _session_iq(b, nf=nf, seed=10 + i)
            start = (pos + off) * block
            iqn = np.asarray(iq)
            sig[:, :, start:start + iqn.shape[-1]] = iqn
            pls.append(np.asarray(pl))
            pos += off + iqn.shape[-1] // block + 1
        blocks = loopback._blockify(jnp.asarray(sig), block)

        out_ref, _ = rx_stream(blocks, RxSessionState.init(b))
        run = halo.time_parallel_rx(mesh, warmup_blocks=3, block=block)
        out_par = run(blocks)

        def frame_set(out):
            v = np.asarray(out.stream_valid).reshape(b, -1)
            fn = np.asarray(out.stream_fn).reshape(b, -1)
            pl = np.asarray(out.stream_payload).reshape(b, -1, 16)
            return {(int(f), bytes(p))
                    for f, p in zip(fn[0][v[0]], pl[0][v[0]])}

        ref_set = frame_set(out_ref)
        par_set = frame_set(out_par)
        # sanity: the sequential run really recovered the sessions
        sent = {(f, bytes(p)) for pl in pls for f, p in enumerate(pl[0])}
        assert len(ref_set & sent) >= sum(nfs) - len(nfs)
        missing = ref_set - par_set
        assert not missing, f"lost {len(missing)} frames: {sorted(missing)[:4]}"
