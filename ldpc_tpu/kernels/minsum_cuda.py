"""Hopper decode kernel: the fixed-point min-sum family on QC-LDPC codes as a
CUDA kernel (csrc/minsum_qc.cu) called through jax.ffi.

One thread block decodes a tile of `tile` codewords with all decoder state
(int16 posteriors, int8 check-to-variable messages) in shared memory for
every iteration, so device memory carries only the int8 channel LLRs in and
the hard bits out. XLA's version of the same decoder (ops/decode_qc.py)
streams that state through device memory once per iteration; it stays the
path for codes whose state does not fit a block (NR Z=384, DVB-S2), for
min* and off the GPU, and it is the reference these kernels are compared
with.

CUDA has no interpret mode, so what the CPU can check lives here in Python:
the entry table the kernel walks (layer_table), the shared-memory footprint
and tile choice (smem_bytes, pick_tile, fits) and the batch padding. The
kernel itself is compared with decode_qc and golden/decoder.py on the card
(tests marked `gpu`, chip_smoke.py).

The shared library is built with nvcc from csrc/minsum_qc.cu into
csrc/build/ on first use (a few seconds, counted as set-up time).
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import LDPCCode
from ..codes.layout import qc_entries
from ..config import DecoderConfig, QuantConfig, cn_params

# Shared memory one Hopper thread block may use (227 KB), and what two
# blocks may each use to share one SM (228 KB per SM, 1 KB reserved per
# block).
SMEM_LIMIT = 232_448
SMEM_PAIR = 233_472 // 2 - 1024
# Codeword tiles tried from widest down; a multiple of 8 keeps the kernel's
# vector copies aligned.
TILES = (32, 16, 8)
MAX_THREADS = 1024
ALGORITHMS = ("min-sum", "offset-min-sum", "normalized-min-sum")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "minsum_qc.cu")
_LIB = os.path.join(_ROOT, "csrc", "build", "libminsum_qc.so")
_TARGET = "ldpc_minsum_qc"


def layer_table(code: LDPCCode) -> np.ndarray:
    """The int32 table the kernel walks: mb + 1 layer offsets into the entry
    list, then col * Z of every entry, then its circulant shift (mod Z)."""
    qc, layers = qc_entries(code)
    off, col_z, shift = [0], [], []
    for ents in layers:
        for j, s in ents:
            col_z.append(j * qc.Z)
            shift.append(s % qc.Z)
        off.append(len(col_z))
    return np.asarray(off + col_z + shift, np.int32)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(code: LDPCCode, tile: int, schedule: str) -> int:
    """Dynamic shared memory of one block, region by region as the kernel
    lays it out: entry table, convergence flags, int16 posteriors (two
    copies when flooding) and int8 messages."""
    qc, layers = qc_entries(code)
    n_entries = sum(len(e) for e in layers)
    post = _align16(code.n * tile * 2)
    return (_align16((qc.mb + 1 + 2 * n_entries) * 4)
            + _align16(2 * tile * 4)
            + post * (2 if schedule == "flooding" else 1)
            + n_entries * qc.Z * tile)


def pick_tile(code: LDPCCode, schedule: str) -> Optional[int]:
    """Widest tile with which two blocks share an SM, else the widest whose
    state fits one block, else None. Two resident blocks hide each other's
    barrier waits: on an H100 the n=648 flooding decode ran fastest at 16
    codewords (two blocks) rather than 32 (one), and n=1944 layered at 8
    rather than 16 (PERF.md)."""
    for limit in (SMEM_PAIR, SMEM_LIMIT):
        for t in TILES:
            if smem_bytes(code, t, schedule) <= limit:
                return t
    return None


def fits(code: LDPCCode, dec: DecoderConfig, quant: QuantConfig) -> bool:
    """Whether the kernel decodes this code and algorithm: a QC code of the
    min-sum family whose posteriors fit int16 and whose state fits a block."""
    if code.base is None or code.Z is None or dec.algorithm not in ALGORITHMS:
        return False
    dv_max = int((code.base >= 0).sum(axis=0).max())
    if quant.qmax * (dv_max + 2) >= 1 << 15:
        return False
    return pick_tile(code, dec.schedule) is not None


def zslots(Z: int, tile: int) -> int:
    """Threads per lane: the largest divisor of Z that keeps the block
    within MAX_THREADS, so every thread owns the same number of rows."""
    cap = MAX_THREADS // tile
    return max(d for d in range(1, min(Z, cap) + 1) if Z % d == 0)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA decode kernel needs the "
                       "CUDA toolkit to build csrc/minsum_qc.cu")


def build_library() -> str:
    """Compile csrc/minsum_qc.cu for sm_90a when the library is missing or
    older than its source. Writes to a temporary name and renames, so two
    processes building at once never load a half-written file."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


@functools.cache
def _register() -> None:
    lib = ctypes.CDLL(build_library())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.LdpcMinsumQc), platform="CUDA")


def make_decoder(code: LDPCCode, dec: DecoderConfig, quant: QuantConfig
                 ) -> Callable[[jnp.ndarray],
                               Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """decode(chan_i8[B, n]) -> (hard u8[B, n], iters i32[B], conv bool[B]),
    bit-identical to ops/decode_qc.py and golden/decoder.py. Any B: the
    batch is padded with zero LLRs to a multiple of the tile (padded lanes
    converge at once and are sliced off). The returned callable carries
    `batch_tile`, the tile granularity."""
    if dec.schedule not in ("flooding", "layered"):
        raise ValueError(dec.schedule)
    if not fits(code, dec, quant):
        raise ValueError(f"{code.name}: {dec.algorithm}/{dec.schedule} is "
                         f"outside the CUDA decode kernel's domain")
    tile = pick_tile(code, dec.schedule)
    table = layer_table(code)
    Z = int(code.Z)
    mb = code.base.shape[0]
    n_entries = (len(table) - mb - 1) // 2
    beta, alpha = cn_params(dec, quant)
    attrs = dict(
        Z=np.int64(Z), mb=np.int64(mb), n_entries=np.int64(n_entries),
        tile=np.int64(tile), zslots=np.int64(zslots(Z, tile)),
        max_iter=np.int64(dec.max_iter), qmax=np.int64(quant.qmax),
        beta=np.int64(beta),
        alpha_num=np.int64(alpha[0] if alpha else 1),
        alpha_shift=np.int64(alpha[1] if alpha else -1),
        flooding=np.int64(dec.schedule == "flooding"),
        early_term=np.int64(dec.early_term))
    n = code.n

    def decode(chan: jnp.ndarray):
        _register()
        B = chan.shape[0]
        Bp = -(-B // tile) * tile
        q = chan.astype(jnp.int8)
        if Bp != B:
            q = jnp.pad(q, ((0, Bp - B), (0, 0)))
        hard, iters, conv = jax.ffi.ffi_call(
            _TARGET,
            (jax.ShapeDtypeStruct((Bp, n), jnp.uint8),
             jax.ShapeDtypeStruct((Bp,), jnp.int32),
             jax.ShapeDtypeStruct((Bp,), jnp.uint8)),
        )(q, jnp.asarray(table), **attrs)
        return hard[:B], iters[:B], conv[:B].astype(bool)

    decode.batch_tile = tile
    return decode
