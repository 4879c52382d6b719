"""M17 puncturing (P1/P2/P3) as static gathers/scatters.

Reference: m17_puncture.cpp.  Puncturing keeps coded bits where the
periodic mask is 1; de-puncturing re-inserts 0.0 soft-bit erasures
(lines 43-79: "0.5 probability", i.e. 0.0 in our signed convention).

Batched: masks are static, so puncture is a precomputed index gather
and de-puncture is a scatter into a zeros array -- both shape-static and
batch-broadcasting, nothing data dependent.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# Periodic puncture masks (m17_puncture.cpp:4-10)
P1 = np.array(
    [1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1,
     1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1,
     0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1],
    dtype=np.int8,
)
P2 = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0], dtype=np.int8)
P3 = np.array([1, 1, 1, 1, 1, 1, 1, 0], dtype=np.int8)

_SCHEMES = {"p1": P1, "p2": P2, "p3": P3}


@functools.lru_cache(maxsize=None)
def _indices(scheme: str, coded_len: int) -> np.ndarray:
    """Positions (into the unpunctured stream) of the kept bits."""
    mask = _SCHEMES[scheme]
    full = np.tile(mask, coded_len // len(mask) + 1)[:coded_len]
    return np.nonzero(full)[0].astype(np.int32)


def punctured_len(scheme: str, coded_len: int) -> int:
    return int(_indices(scheme, coded_len).shape[0])


def puncture(x: jnp.ndarray, scheme: str) -> jnp.ndarray:
    """Drop masked bits from [..., coded_len] (hard bits or soft bits).

    Reference: m17_punc_p1/p2/p3 (m17_puncture.cpp:12-41).
    """
    idx = _indices(scheme, x.shape[-1])
    return jnp.take(x, jnp.asarray(idx), axis=-1)


def depuncture(x: jnp.ndarray, scheme: str, coded_len: int) -> jnp.ndarray:
    """Re-insert 0.0 erasures -> [..., coded_len] soft bits.

    Reference: m17_de_punc_p1/p2/p3 (m17_puncture.cpp:47-79).
    """
    idx = _indices(scheme, coded_len)
    out = jnp.zeros((*x.shape[:-1], coded_len), dtype=x.dtype)
    return out.at[..., jnp.asarray(idx)].set(x)
