"""ldpc_tpu — a fixed-point LDPC coding framework on JAX.

A JAX/XLA implementation, with a CUDA decode kernel, of the capabilities of
tyc85/FixedPointLDPC (a C/MATLAB fixed-point LDPC simulator; see SURVEY.md):
QC-LDPC code construction (IEEE 802.11n, 5G NR, DVB-S2), sparse GF(2) encoding,
BPSK/QAM + AWGN + LLR demapping, fixed-point min-sum / offset-min-sum belief
propagation (flooding and layered schedules, syndrome early termination), and a
Monte-Carlo BER/FER sweep harness sharded over device meshes.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    ChannelConfig,
    CodeConfig,
    DecoderConfig,
    PRESETS,
    QuantConfig,
    RunConfig,
    SimConfig,
)
