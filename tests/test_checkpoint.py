"""Checkpoint/resume (SURVEY.md section 5.4; VERDICT round-1 item 6).

A streaming session suspended at an arbitrary block boundary and resumed
from the checkpoint file must produce BIT-IDENTICAL outputs to the
uninterrupted run -- all modem carry (timing loop, framer FSM, LICH
assembly, AFC/DC, FIR tails) lives in one pytree.
"""

import numpy as np
import pytest

from m17_sdr.app.checkpoint import load_state, save_state
from m17_sdr.app.session import Session
from m17_sdr.app.streaming import StreamingRx, wire_block_iter
from m17_sdr.pipeline.rx import RxSessionState


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    td = tmp_path_factory.mktemp("ckpt")
    iq = str(td / "cap.iq")
    s = Session()
    s.tx_file(iq, n_frames=10)
    return iq


def _run(iq, split_at=None, td=None):
    srx = StreamingRx(batch=1, chunk_blocks=6)
    blocks = list(wire_block_iter(iq, srx.block_in))
    if split_at is None:
        for b in blocks:
            srx.feed_block(b)
        return srx.finish()
    ck = str(td / f"state_{split_at}.npz")
    for b in blocks[:split_at]:
        srx.feed_block(b)
    srx.checkpoint(ck)
    out1, _, n1 = srx.finish()

    srx2 = StreamingRx(batch=1, chunk_blocks=6)
    srx2.resume(ck)
    for b in blocks[split_at:]:
        srx2.feed_block(b)
    out2, state2, n2 = srx2.finish()
    # stitch the two halves
    import jax

    if out1 is None:
        return out2, state2, n2
    out = jax.tree.map(
        lambda a, b: np.concatenate([a, b], axis=1) if a.ndim >= 2 else b,
        out1, out2)
    return out, state2, n1 + n2


class TestCheckpointResume:
    @pytest.mark.parametrize("split_at", [1, 5, 8, 11])
    def test_split_resume_bit_identical(self, capture, split_at, tmp_path):
        ref_out, ref_state, ref_n = _run(capture)
        out, state, n = _run(capture, split_at=split_at, td=tmp_path)
        assert n == ref_n
        import jax

        for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(ref_out)[0],
            jax.tree_util.tree_flatten_with_path(out)[0],
        ):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=str(pa))
        for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(ref_state)[0],
            jax.tree_util.tree_flatten_with_path(state)[0],
        ):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=str(pa))

    def test_rejects_mismatched_template(self, tmp_path):
        p = str(tmp_path / "s.npz")
        save_state(p, RxSessionState.init(2))
        with pytest.raises(ValueError):
            load_state(p, RxSessionState.init(3))

    def test_cli_roundtrip(self, capture, tmp_path):
        """rx --save-state / --resume-state splits a capture and decodes
        the same payloads as the continuous run."""
        import subprocess
        import sys

        # split the capture file at block 6
        data = np.fromfile(capture, dtype="<i2")
        half = 6 * 1920 * 2
        f1, f2 = str(tmp_path / "a.iq"), str(tmp_path / "b.iq")
        data[:half].tofile(f1)
        data[half:].tofile(f2)
        ck = str(tmp_path / "st.npz")
        p1, p2 = str(tmp_path / "p1.bin"), str(tmp_path / "p2.bin")
        pref = str(tmp_path / "pref.bin")

        def run(args):
            r = subprocess.run(
                [sys.executable, "-m", "m17_sdr.app.main",
                 "--platform", "cpu"] + args,
                check=True, capture_output=True, text=True, cwd="/root/repo")
            return r.stdout

        run(["rx", "--in", capture, "--payload-out", pref])
        run(["rx", "--in", f1, "--save-state", ck, "--payload-out", p1])
        run(["rx", "--in", f2, "--resume-state", ck, "--payload-out", p2])
        with open(pref, "rb") as f:
            want = f.read()
        with open(p1, "rb") as f1b, open(p2, "rb") as f2b:
            got = f1b.read() + f2b.read()
        assert got == want
