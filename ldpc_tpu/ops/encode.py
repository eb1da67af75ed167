"""Batched GF(2) systematic encoders as jittable XLA ops.

The reference encodes one codeword at a time with dual-diagonal
back-substitution (BASELINE.json:5 'sparse parity-check encoding'; IEEE
802.11-2012 Annex F). Two batched realizations:

  * small codes (802.11n sizes): one batched matmul against the
    precomputed dense parity generator — parity = (info @ P^T) mod 2, bf16
    inputs with exact f32 accumulation;
  * structured QC codes of any size (802.11n, NR-like, DVB-S2-like): the
    O(E) block-circulant dual-diagonal encoder (codes/qcstruct.py), pure
    rolls and XORs — the dense path would need a multi-hundred-MB H for
    DVB-S2's n=64800.

Bit-exactness vs the golden encoders is asserted in tests; H c^T = 0 is the
universal property.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import LDPCCode

_DENSE_MAX_N = 4096


def _has_qc_struct(code: LDPCCode) -> bool:
    if code.base is None or code.Z is None:
        return False
    from ..codes.qcstruct import detect_enc_struct
    return detect_enc_struct(code.base) is not None


def info_positions(code: LDPCCode) -> np.ndarray:
    """Codeword positions of the k information bits."""
    if _has_qc_struct(code) and code.n > _DENSE_MAX_N:
        return np.arange(code.k)
    from ..golden.encoder import systematic_form
    _, perm = systematic_form(code)
    return np.asarray(perm[: code.k])


def make_encoder(code: LDPCCode) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Returns encode(info[B, k] uint8) -> codeword[B, n] uint8, jittable."""
    if _has_qc_struct(code) and code.n > _DENSE_MAX_N:
        from ..codes.qcstruct import make_qc_encoder
        return make_qc_encoder(code)
    return _make_dense_encoder(code)


def _make_dense_encoder(code: LDPCCode) -> Callable[[jnp.ndarray], jnp.ndarray]:
    from ..golden.encoder import systematic_form

    P, perm = systematic_form(code)  # (m, k), (n,)
    PT = jnp.asarray(P.T.astype(np.float32), jnp.bfloat16)  # (k, m)
    identity_perm = bool(np.all(perm == np.arange(code.n)))
    perm_j = None if identity_perm else jnp.asarray(perm)

    def encode(info: jnp.ndarray) -> jnp.ndarray:
        # Exact: 0/1 operands are exact in bf16 and every partial sum is an
        # integer below k < 2**24, which float32 accumulation holds exactly.
        x = info.astype(jnp.bfloat16)
        acc = jnp.dot(x, PT, preferred_element_type=jnp.float32)
        parity = (acc.astype(jnp.int32) & 1).astype(jnp.uint8)
        c = jnp.concatenate([info.astype(jnp.uint8), parity], axis=-1)
        if perm_j is not None:
            c = jnp.zeros_like(c).at[..., perm_j].set(c)
        return c

    return encode
