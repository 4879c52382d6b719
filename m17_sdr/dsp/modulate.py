"""TX modulator: dibits -> RRC-shaped 4FSK complex baseband.

Reference: m17_modulate.cpp.  The scalar design pushes one dibit at a
time through a 31-tap polyphase interpolator and a phase-accumulator
NCO.  Here the whole block is computed at once, batched over channels:

  dibits [B, N] --lookup--> phase increments [B, N]
         --window+matmul--> interpolated increments [B, N*os]
         --carry + cumsum--> absolute phase [B, N*os]
         --cos/sin--------> complex IQ [B, N*os]

The only sequential state is the 30-symbol filter tail and the NCO
phase, carried as a small pytree between blocks so arbitrarily long
transmissions stream block-by-block with bit-identical output.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..spec.constants import DIBIT_TO_PHASE_INC, SAMPLES_PER_SYMBOL, TX_FILTER_TAPS
from . import iq as iqmod
from .filters import tx_rrc_polyphase

HIGHEST = jax.lax.Precision.HIGHEST


class ModState(NamedTuple):
    """Per-channel modulator carry (reference statics m17_modulate.cpp:7-15)."""

    filter_tail: jnp.ndarray  # [B, TX_FILTER_TAPS-1] trailing phase increments
    phase: jnp.ndarray        # [B] NCO phase accumulator (radians)

    @staticmethod
    def init(batch: int) -> "ModState":
        return ModState(
            filter_tail=jnp.zeros((batch, TX_FILTER_TAPS - 1), dtype=jnp.float32),
            phase=jnp.zeros((batch,), dtype=jnp.float32),
        )


@functools.partial(jax.jit, static_argnames=("oversample",))
def modulate_dibits(
    dibits: jnp.ndarray,
    state: ModState,
    oversample: int = SAMPLES_PER_SYMBOL,
) -> tuple[jnp.ndarray, ModState]:
    """Modulate [B, N] dibits -> ([B, 2, N*oversample] planar IQ, new state).

    Reference flow: m17_mod_dibits -> mod_filter -> mod_fsk
    (m17_modulate.cpp:79-86, 49-61, 22-38).
    """
    bank = jnp.asarray(tx_rrc_polyphase(oversample))       # [31, os]
    # DIBIT_TO_PHASE_INC is radians per 48 kHz sample; at higher device
    # rates the per-sample step shrinks so the deviation stays +-800/
    # +-2400 Hz.  (The reference gets this implicitly by keeping its
    # mother-filter gain at 10 for any oversample, m17_modulate.cpp:73.)
    scale = SAMPLES_PER_SYMBOL / oversample
    inc = jnp.asarray(DIBIT_TO_PHASE_INC)[dibits] * scale  # [B, N]
    hist = jnp.concatenate([state.filter_tail, inc], axis=-1)  # [B, N+30]

    n = dibits.shape[-1]
    # windows[b, t, j] = hist[b, t + j] = x[t - 30 + j]
    idx = np.arange(n)[:, None] + np.arange(TX_FILTER_TAPS)[None, :]
    windows = hist[:, jnp.asarray(idx)]                    # [B, N, 31]
    # HIGHEST: the shaped phase becomes int16 IQ, which is compared
    # bit for bit; TF32 would keep only ~3 decimal digits
    shaped = jnp.matmul(windows, bank, precision=HIGHEST)  # [B, N, os]
    shaped = shaped.reshape(dibits.shape[0], n * oversample)

    phase = state.phase[:, None] + jnp.cumsum(shaped, axis=-1)
    out = iqmod.from_phase(phase)                          # [B, 2, T]

    # wrap the carried phase to keep the accumulator bounded
    # (m17_modulate.cpp:33-37)
    new_phase = jnp.mod(phase[:, -1], 2.0 * np.pi)
    new_state = ModState(filter_tail=hist[:, -(TX_FILTER_TAPS - 1):],
                         phase=new_phase)
    return out, new_state


def modulate_carrier(
    batch: int, nsymbols: int, state: ModState,
    oversample: int = SAMPLES_PER_SYMBOL,
) -> tuple[jnp.ndarray, ModState]:
    """Unmodulated carrier: zero phase increments through the same chain
    (m17_mod_carrier, m17_modulate.cpp:88-92)."""
    bank = jnp.asarray(tx_rrc_polyphase(oversample))
    zeros = jnp.zeros((batch, nsymbols), dtype=jnp.float32)
    hist = jnp.concatenate([state.filter_tail, zeros], axis=-1)
    idx = np.arange(nsymbols)[:, None] + np.arange(TX_FILTER_TAPS)[None, :]
    shaped = jnp.matmul(hist[:, jnp.asarray(idx)], bank,
                        precision=HIGHEST).reshape(batch, nsymbols * oversample)
    phase = state.phase[:, None] + jnp.cumsum(shaped, axis=-1)
    out = iqmod.from_phase(phase)
    new_state = ModState(filter_tail=hist[:, -(TX_FILTER_TAPS - 1):],
                         phase=jnp.mod(phase[:, -1], 2.0 * np.pi))
    return out, new_state


def iq_to_int16(iq2: jnp.ndarray) -> jnp.ndarray:
    """Scale unit-circle planar IQ [..., 2, T] to the int16 wire format,
    interleaved re/im [..., T, 2].

    Reference scales by 0x3FFF (m17_modulate.cpp:25-26).
    """
    return jnp.moveaxis((iq2 * 0x3FFF), -2, -1).astype(jnp.int16)
