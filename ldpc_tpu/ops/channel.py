"""Modulation, AWGN channel, and LLR demapping as jittable XLA ops.

Covers the reference's channel layer (BASELINE.json:5 'AWGN channel + BPSK/QAM
LLR computation', :11 'QAM mod + AWGN + LLR demap'): BPSK and Gray-mapped
square QAM (QPSK/16/64), unit average symbol energy, max-log per-bit LLRs
computed per axis (exact for Gray-labeled square QAM). Plus the DVB-S2
family's native constellations — 8PSK and 16/32APSK (ring geometry per
EN 302 307-1; quasi-Gray labeling, see _quadrant_gray_rings) — demapped by
generic full-constellation max-log.

Conventions (shared with the golden model):
  * bit 0 -> +amplitude on its axis; LLR > 0 means bit 0.
  * BPSK over the real AWGN channel: sigma**2 = 1/(2 R EbN0_lin),
    LLR = 2 y / sigma**2.
  * QAM over the complex channel (I/Q as two reals): per-dimension noise
    variance sigma**2 = N0/2 with N0 = 1/(R m EbN0_lin), m bits/symbol, Es = 1.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

MODULATIONS = ("bpsk", "qpsk", "16qam", "64qam", "8psk", "16apsk", "32apsk")

BITS_PER_SYM = {"bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6,
                "8psk": 3, "16apsk": 4, "32apsk": 5}

# DVB-S2 ring-radius ratios (EN 302 307-1 Tables 9/10 give gamma per code
# rate; these defaults are the lowest-rate entries — 16APSK r2/3, 32APSK
# r3/4). The ratio only shapes the constellation geometry; the demapper is
# generic max-log over the point set, so changing it touches nothing else.
APSK_GAMMA = {"16apsk": (3.15,), "32apsk": (2.84, 5.27)}


def _gray_levels(bits_per_axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """PAM levels and their Gray bit labels for one axis.

    Returns (levels[L] float64 unnormalized odd integers ..-3,-1,1,3..,
             labels[L, bits_per_axis] uint8) where labels follow the standard
    reflected-Gray mapping with MSB first (bit 0 selects the sign half).
    """
    L = 1 << bits_per_axis
    levels = np.arange(-(L - 1), L, 2, dtype=np.float64)
    idx = np.arange(L)
    gray = idx ^ (idx >> 1)
    # level i (ascending) carries gray code of i, but with MSB inverted so that
    # bit pattern 0.. maps to the positive side (bit 0 -> +): flip order.
    labels = np.zeros((L, bits_per_axis), np.uint8)
    for i in range(L):
        g = gray[L - 1 - i]  # descending gray index on ascending levels
        for b in range(bits_per_axis):
            labels[i, b] = (g >> (bits_per_axis - 1 - b)) & 1
    return levels, labels


def _axis_norm(bits_per_axis: int) -> float:
    L = 1 << bits_per_axis
    levels = np.arange(-(L - 1), L, 2, dtype=np.float64)
    mean_sq = float(np.mean(levels**2))
    return 1.0 / math.sqrt(2.0 * mean_sq)  # two axes share Es = 1


def _quadrant_gray_rings(ring_counts: Tuple[int, ...],
                         radii: Tuple[float, ...], m: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Quasi-Gray labeled concentric-ring (APSK/PSK) constellation.

    Construction (quadrant-symmetric, like the DVB-S2 figures): the two MSBs
    Gray-code the quadrant (00,01,11,10 counter-clockwise); the remaining
    m-2 bits select the point inside the quadrant, swept boustrophedon per
    ring so labels at quadrant boundaries match across the seam — every
    angularly adjacent pair on a ring then differs in exactly one bit. Ring
    identity lives in the within-quadrant bits (rings get disjoint code
    sets). Labeling is implementation-defined quasi-Gray, NOT the published
    DVB-S2 bit map (standard_exact=False in the repo's convention); ring
    counts and radius ratios are the standard's, with every ring phased at
    (2t+1)*pi/count so no point sits on a quadrant boundary (for 8PSK that
    is the standard ring rotated pi/8 — performance-invariant on AWGN).

    Returns (points[M, 2] unit-Es float64, labels[M, m] uint8).
    """
    assert all(c % 4 == 0 for c in ring_counts)
    M = sum(ring_counts)
    assert M == 1 << m
    pts = np.zeros((M, 2), np.float64)
    labels = np.zeros((M, m), np.uint8)
    quad_gray = (0b00, 0b01, 0b11, 0b10)  # CCW quadrants
    inner_bits = m - 2
    # Within-quadrant code walk per ring: disjoint code sets covering
    # [0, 2**inner_bits), each listed in an order whose consecutive steps
    # (and endpoints, for the boustrophedon seam) flip exactly one bit.
    ring_walks = {
        (8,): ([0, 1],),                       # 8PSK: 2 per quadrant
        (4, 12): ([2], [0, 1, 3]),             # 16APSK: inner 1, outer 3
        (4, 12, 16): ([6], [4, 5, 7], [0, 1, 3, 2]),  # 32APSK: 1 + 3 + 4
    }[ring_counts]
    i = 0
    for cnt, rad, walk in zip(ring_counts, radii, ring_walks):
        per_quad = cnt // 4
        assert len(walk) == per_quad
        for q in range(4):
            idx = walk if q % 2 == 0 else walk[::-1]  # boustrophedon
            for j in range(per_quad):
                # DVB-S2-style ring phases: points at (2t+1)*pi/cnt (axis-
                # symmetric, none on a quadrant boundary)
                t = q * per_quad + j
                ang = (2 * t + 1) * math.pi / cnt
                pts[i] = (rad * math.cos(ang), rad * math.sin(ang))
                code = (quad_gray[q] << inner_bits) | idx[j]
                for b in range(m):
                    labels[i, b] = (code >> (m - 1 - b)) & 1
                i += 1
    es = float(np.mean(np.sum(pts**2, axis=-1)))
    assert len({tuple(l) for l in labels}) == M  # all labels distinct
    return pts / math.sqrt(es), labels


def _constellation(modulation: str) -> Tuple[np.ndarray, np.ndarray]:
    """(points[M, 2] unit-Es, labels[M, m]) for the generic (non-separable)
    constellations: 8PSK and DVB-S2-geometry 16/32APSK."""
    m = BITS_PER_SYM[modulation]
    if modulation == "8psk":
        return _quadrant_gray_rings((8,), (1.0,), m)
    if modulation == "16apsk":
        (g,) = APSK_GAMMA["16apsk"]
        return _quadrant_gray_rings((4, 12), (1.0, g), m)
    if modulation == "32apsk":
        g1, g2 = APSK_GAMMA["32apsk"]
        return _quadrant_gray_rings((4, 12, 16), (1.0, g1, g2), m)
    raise ValueError(f"no generic constellation for {modulation}")


def sigma_for(ebn0_db: float, rate: float, modulation: str) -> float:
    """Per-real-dimension noise standard deviation for Es = 1."""
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    m = BITS_PER_SYM[modulation]
    if modulation == "bpsk":
        return math.sqrt(1.0 / (2.0 * rate * ebn0))
    n0 = 1.0 / (rate * m * ebn0)
    return math.sqrt(n0 / 2.0)


def modulate(bits: jnp.ndarray, modulation: str) -> jnp.ndarray:
    """bits (..., n) in {0,1} -> symbols.

    BPSK: (..., n) real. QAM: (..., n/m, 2) with I/Q as the trailing axis.
    """
    if modulation == "bpsk":
        return (1 - 2 * bits.astype(jnp.int32)).astype(jnp.float32)
    m = BITS_PER_SYM[modulation]
    if modulation in ("8psk", "16apsk", "32apsk"):
        pts, labels = _constellation(modulation)
        # label-int -> point lookup
        lut = np.zeros((1 << m, 2), np.float32)
        for i in range(len(pts)):
            key = 0
            for b in range(m):
                key = (key << 1) | int(labels[i, b])
            lut[key] = pts[i]
        g = bits.reshape(bits.shape[:-1] + (-1, m))  # (..., nsym, m)
        weights = jnp.asarray([1 << (m - 1 - b) for b in range(m)], jnp.int32)
        keys = jnp.sum(g.astype(jnp.int32) * weights, axis=-1)
        return jnp.asarray(lut)[keys]  # (..., nsym, 2)
    ba = m // 2
    levels, labels = _gray_levels(ba)
    norm = _axis_norm(ba)
    # label -> level lookup table indexed by the integer formed by the bits
    lut = np.zeros(1 << ba, np.float32)
    for i in range(len(levels)):
        key = 0
        for b in range(ba):
            key = (key << 1) | int(labels[i, b])
        lut[key] = levels[i] * norm
    lut_j = jnp.asarray(lut)
    g = bits.reshape(bits.shape[:-1] + (-1, 2, ba))  # (..., nsym, axis, ba)
    weights = jnp.asarray([1 << (ba - 1 - b) for b in range(ba)], jnp.int32)
    keys = jnp.sum(g.astype(jnp.int32) * weights, axis=-1)
    return lut_j[keys]  # (..., nsym, 2)


def _bcast_sigma(sigma, x: jnp.ndarray):
    """Scalar sigma, or per-codeword sigma (B,) broadcast over x (B, ...) —
    the fused-SNR-sweep path (SURVEY.md §2.3 'sweep parallelism')."""
    sigma = jnp.asarray(sigma, x.dtype)
    if sigma.ndim == 0:
        return sigma
    return sigma.reshape((-1,) + (1,) * (x.ndim - 1))


def awgn(key: jax.Array, x: jnp.ndarray, sigma) -> jnp.ndarray:
    return x + _bcast_sigma(sigma, x) * jax.random.normal(key, x.shape, x.dtype)


def demap(y: jnp.ndarray, sigma, modulation: str) -> jnp.ndarray:
    """Received symbols -> per-bit float LLRs (..., n). Max-log for QAM.
    sigma: scalar or per-codeword (B,)."""
    if modulation == "bpsk":
        sb = _bcast_sigma(sigma, y)
        return 2.0 * y / (sb * sb)
    m = BITS_PER_SYM[modulation]
    if modulation in ("8psk", "16apsk", "32apsk"):
        # Generic max-log over the full point set (M <= 32): one broadcast
        # distance tensor + per-bit masked min-reduces; XLA fuses the chain.
        pts, labels = _constellation(modulation)
        sb = _bcast_sigma(sigma, y)
        n0 = 2.0 * sb * sb
        pj = jnp.asarray(pts, jnp.float32)  # (M, 2)
        d2 = jnp.sum((y[..., None, :] - pj) ** 2, axis=-1)  # (..., nsym, M)
        big = jnp.float32(1e30)
        lab = np.asarray(labels, bool)  # (M, m)
        n0b = n0 if n0.ndim == 0 else jnp.squeeze(n0, -1)  # bcast vs (.., nsym)
        llrs = []
        for b in range(m):
            m0 = jnp.min(jnp.where(jnp.asarray(~lab[:, b]), d2, big), axis=-1)
            m1 = jnp.min(jnp.where(jnp.asarray(lab[:, b]), d2, big), axis=-1)
            llrs.append((m1 - m0) / n0b)  # (..., nsym)
        return jnp.stack(llrs, axis=-1).reshape(y.shape[:-2] + (-1,))
    ba = m // 2
    levels, labels = _gray_levels(ba)
    norm = _axis_norm(ba)
    lev = jnp.asarray(levels * norm, jnp.float32)  # (L,)
    lab = np.asarray(labels, bool)  # (L, ba)
    sb = _bcast_sigma(sigma, y)
    n0 = 2.0 * sb * sb
    # y: (..., nsym, 2); per-axis distances to each level
    d2 = (y[..., None] - lev) ** 2  # (..., nsym, 2, L)
    big = jnp.float32(1e30)
    llrs = []
    for b in range(ba):
        m0 = jnp.min(jnp.where(jnp.asarray(~lab[:, b]), d2, big), axis=-1)
        m1 = jnp.min(jnp.where(jnp.asarray(lab[:, b]), d2, big), axis=-1)
        llrs.append((m1 - m0) / n0)  # (..., nsym, 2)
    # Interleave back to bit order: per symbol the bits are
    # [I_b0..I_b(ba-1), Q_b0..Q_b(ba-1)]? No — modulate consumed
    # (..., nsym, axis, ba), i.e. I-bits first then Q-bits.
    stack = jnp.stack(llrs, axis=-1)  # (..., nsym, 2, ba)
    return stack.reshape(y.shape[:-2] + (-1,))


def llrs_bpsk_exact(y: jnp.ndarray, sigma: float) -> jnp.ndarray:
    return demap(y, sigma, "bpsk")


def bsc(key: jax.Array, bits: jnp.ndarray, p) -> jnp.ndarray:
    """Binary symmetric channel: flip each bit independently with probability
    p. The SURVEY.md §5.3 stress-test fault injector (`bitflip_channel`) —
    hard bit-flip faults rather than soft AWGN noise."""
    flips = jax.random.bernoulli(key, p, bits.shape)
    return jnp.bitwise_xor(bits.astype(jnp.uint8), flips.astype(jnp.uint8))


def bsc_llr(bits: jnp.ndarray, p) -> jnp.ndarray:
    """Channel LLRs for hard BSC observations: LLR = (1 - 2y) * log((1-p)/p)
    (> 0 favors bit 0, matching the demap sign convention)."""
    p = jnp.asarray(p, jnp.float32)
    mag = jnp.log((1.0 - p) / p)
    return (1 - 2 * bits.astype(jnp.float32)) * mag
