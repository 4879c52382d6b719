"""The GPU entry points' CPU-side contracts: the compile-cache location,
chip_smoke.py's refusal to run without a GPU, and the compiled Viterbi
kernel on the card (marked `gpu`)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m17_sdr import compile_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the
    helper reports it and sets nothing in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_the_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_chip_smoke_refuses_a_cpu_only_host():
    r = _run_smoke(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert "needs 1 GPU" in r.stderr
    assert not _printed_result(r.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the
    script cannot import the program and exits non-zero."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


@pytest.mark.gpu
def test_compiled_viterbi_kernel_matches_xla(gpu):
    from m17_sdr.fec.viterbi import viterbi_decode_xla
    from m17_sdr.fec.viterbi_pallas import viterbi_decode_pallas

    rng = np.random.default_rng(5)
    soft = jnp.asarray(rng.normal(size=(1000, 488)).astype(np.float32))
    b_ref, m_ref = viterbi_decode_xla(soft, return_metric=True)
    b_pal, m_pal = viterbi_decode_pallas(soft, return_metric=True)
    np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b_pal))
    np.testing.assert_allclose(np.asarray(m_pal), np.asarray(m_ref),
                               rtol=1e-5)
