"""m17_sdr: a batched M17 digital-radio baseband framework in JAX.

A from-scratch JAX/XLA/Pallas re-architecture of the capabilities of
G4GUO/m17_sdr (the `m17gismo` C++ SDR transceiver): the complete M17
4FSK modem -- RRC pulse shaping, FM discrimination, polyphase symbol
timing recovery, frame sync, soft-decision FEC (K=5 Viterbi,
Golay(24,12), CRC-16), the link/stream/packet/BERT frame formats, and
the M17-over-UDP reflector protocol -- as batched, mesh-shardable
kernels over thousands of independent channels.
"""

__version__ = "0.1.0"
