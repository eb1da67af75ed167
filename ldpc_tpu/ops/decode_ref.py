"""Reference decoder as pure-XLA jnp ops (batched, jittable, any backend).

This is the framework's portable decoder (SURVEY.md §2.1 C8 'pure-XLA jnp
fallback'): the same fixed-point min-sum / offset-min-sum message passing as
the golden model (golden/decoder.py — the bit-exactness oracle) and the QC
decoders (ops/decode_qc.py, kernels/minsum_cuda.py), expressed with dense
padded gathers so XLA can vectorize it for any code, QC or not.

Layout: messages live check-major in a flat (m*max_dc + 1) buffer per codeword;
the last slot is a zero dump/pad slot (see codes/layout.py). The flooding
update is gather-only (no scatters); the layered update scatters disjoint
per-layer slices (guaranteed collision-free by the layer invariant).

Early termination is batched: a per-codeword `done` mask freezes converged
lanes (identical results to the golden model's per-codeword stop), and a
whole-batch while_loop exit stops compute when every lane has converged
(BASELINE.json:8 'early termination'; SURVEY.md §7.3 item 3).
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import LDPCCode
from ..codes.layout import compile_edge_layout, compile_layers_general
from ..config import DecoderConfig, QuantConfig

# numpy scalar, NOT jnp: a module-level jnp constant materializes a device
# array at import time, which INITIALIZES the JAX backend and latches
# jax_platforms before any script can call jax.config.update (--platform
# cpu would then silently run on the accelerator)
_BIG = np.int32(1 << 15)


def _cn_update(v2c: jnp.ndarray, mask: jnp.ndarray, beta: int,
               alpha=None) -> jnp.ndarray:
    """Min-sum CN update on dense (..., C, D) int32 messages.

    Pad slots must already hold +qmax (so they never win the min and contribute
    positive sign); output pads are zeroed. alpha = (num, shift) applies the
    normalized-min-sum dyadic scaling (golden._mag_xform semantics).
    """
    mags = jnp.abs(v2c)
    amin = jnp.argmin(mags, axis=-1)[..., None]
    slots = jax.lax.broadcasted_iota(jnp.int32, v2c.shape, v2c.ndim - 1)
    min1 = jnp.min(mags, axis=-1, keepdims=True)
    min2 = jnp.min(jnp.where(slots == amin, _BIG, mags), axis=-1, keepdims=True)
    neg = v2c < 0
    par = (jnp.sum(neg, axis=-1, keepdims=True) & 1).astype(bool)
    excl_neg = jnp.logical_xor(par, neg)
    excl_mag = jnp.where(slots == amin, min2, min1)
    if alpha is not None:
        excl_mag = jnp.right_shift(excl_mag * alpha[0], alpha[1])
    mag = jnp.maximum(excl_mag - beta, 0)
    val = jnp.where(excl_neg, -mag, mag)
    return jnp.where(mask, val, 0)


def _syndrome_ok(hard_pad: jnp.ndarray, ev: jnp.ndarray) -> jnp.ndarray:
    """hard_pad: (B, n+1) int32 bits with zero pad; ev: (m, D) var index per
    slot (pad = n). Returns (B,) bool."""
    bits = hard_pad[:, ev]  # (B, m, D)
    synd = jnp.sum(bits, axis=-1) & 1
    return ~jnp.any(synd.astype(bool), axis=-1)


def make_flooding_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    early_term: bool = True,
    alpha=None,
) -> Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Returns decode(chan_i8[B, n]) -> (hard[B, n] uint8, iters[B] i32,
    converged[B] bool)."""
    lay = compile_edge_layout(code)
    M, D, N = lay.m, lay.max_dc, lay.n
    ev = jnp.asarray(lay.ev_dense)        # (M, D) pad N
    vn_pos = jnp.asarray(lay.vn_pos)      # (N, max_dv) pad M*D
    mask = jnp.asarray(lay.cn_mask)       # (M, D)
    qmax_j = jnp.int32(qmax)

    def totals(chan32, c2v_flat):
        return chan32 + jnp.sum(c2v_flat[:, vn_pos], axis=-1)

    def pad1(x):
        return jnp.pad(x, ((0, 0), (0, 1)))

    def decode(chan: jnp.ndarray):
        B = chan.shape[0]
        chan32 = chan.astype(jnp.int32)
        c2v_flat = jnp.zeros((B, M * D + 1), jnp.int32)
        hard0 = (chan32 < 0)
        done0 = (_syndrome_ok(pad1(hard0.astype(jnp.int32)), ev)
                 if early_term else jnp.zeros(B, bool))
        iters0 = jnp.zeros(B, jnp.int32)

        def body(carry):
            it, c2v_flat, hard, done, iters = carry
            tot_pad = pad1(totals(chan32, c2v_flat))
            c2v_d = c2v_flat[:, : M * D].reshape(B, M, D)
            v2c = jnp.clip(tot_pad[:, ev] - c2v_d, -qmax_j, qmax_j)
            v2c = jnp.where(mask, v2c, qmax_j)
            new = _cn_update(v2c, mask, beta, alpha)
            new_flat = pad1(new.reshape(B, M * D))
            tot2 = totals(chan32, new_flat)
            hard_new = tot2 < 0
            ok_new = _syndrome_ok(pad1(hard_new.astype(jnp.int32)), ev)
            c2v_flat = jnp.where(done[:, None], c2v_flat, new_flat)
            hard = jnp.where(done[:, None], hard, hard_new)
            iters = iters + (~done).astype(jnp.int32)
            done = done | ok_new if early_term else done
            return it + 1, c2v_flat, hard, done, iters

        carry = (jnp.int32(0), c2v_flat, hard0, done0, iters0)
        if early_term:
            def cond(carry):
                it, _, _, done, _ = carry
                return (it < max_iter) & ~jnp.all(done)
            carry = jax.lax.while_loop(cond, body, carry)
        else:
            carry = jax.lax.fori_loop(0, max_iter,
                                      lambda _, c: body(c), carry)
        _, c2v_flat, hard, done, iters = carry
        if early_term:
            conv = done
        else:
            conv = _syndrome_ok(pad1(hard.astype(jnp.int32)), ev)
        return hard.astype(jnp.uint8), iters, conv

    return decode


def make_layered_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    early_term: bool = True,
    alpha=None,
) -> Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Layered-schedule decoder; layers = QC base rows when available, else a
    greedy disjoint grouping (codes/layout.py)."""
    lay = compile_edge_layout(code)
    M, D, N = lay.m, lay.max_dc, lay.n
    DUMP = M * D

    if code.base is not None and code.Z is not None:
        Z = int(code.Z)
        layers = [np.arange(i * Z, (i + 1) * Z, dtype=np.int32)
                  for i in range(code.m // Z)]
    else:
        layers = compile_layers_general(code)
    L = len(layers)
    Cmax = max(len(l) for l in layers)

    lpos = np.full((L, Cmax, D), DUMP, np.int32)
    lev = np.full((L, Cmax, D), N, np.int32)
    lmask = np.zeros((L, Cmax, D), bool)
    for li, checks in enumerate(layers):
        for t, c in enumerate(checks):
            m_ = lay.cn_mask[c]
            lpos[li, t][m_] = c * D + np.nonzero(m_)[0]
            lev[li, t] = lay.ev_dense[c]
            lmask[li, t] = m_
    lpos_j, lev_j, lmask_j = map(jnp.asarray, (lpos, lev, lmask))
    ev = jnp.asarray(lay.ev_dense)
    qmax_j = jnp.int32(qmax)

    def decode(chan: jnp.ndarray):
        B = chan.shape[0]
        chan32 = chan.astype(jnp.int32)
        c2v0 = jnp.zeros((B, M * D + 1), jnp.int32)
        post0 = jnp.pad(chan32, ((0, 0), (0, 1)))
        hard0 = chan32 < 0
        done0 = (_syndrome_ok(jnp.pad(hard0.astype(jnp.int32), ((0, 0), (0, 1))), ev)
                 if early_term else jnp.zeros(B, bool))
        iters0 = jnp.zeros(B, jnp.int32)

        def layer_body(l, state):
            c2v_flat, post_pad = state
            pos, evl, mk = lpos_j[l], lev_j[l], lmask_j[l]
            c2v_l = c2v_flat[:, pos]
            v2c = jnp.clip(post_pad[:, evl] - c2v_l, -qmax_j, qmax_j)
            v2c = jnp.where(mk, v2c, qmax_j)
            new = _cn_update(v2c, mk, beta, alpha)
            delta = jnp.where(mk, new - c2v_l, 0)
            post_pad = post_pad.at[:, evl.reshape(-1)].add(
                delta.reshape(B, -1))
            c2v_flat = c2v_flat.at[:, pos.reshape(-1)].set(
                new.reshape(B, -1))
            return c2v_flat, post_pad

        def body(carry):
            it, c2v_flat, post_pad, hard, done, iters = carry
            c2v_new, post_new = jax.lax.fori_loop(
                0, L, layer_body, (c2v_flat, post_pad))
            hard_new = post_new[:, :N] < 0
            ok_new = _syndrome_ok(
                jnp.pad(hard_new.astype(jnp.int32), ((0, 0), (0, 1))), ev)
            c2v_flat = jnp.where(done[:, None], c2v_flat, c2v_new)
            post_pad = jnp.where(done[:, None], post_pad, post_new)
            hard = jnp.where(done[:, None], hard, hard_new)
            iters = iters + (~done).astype(jnp.int32)
            done = done | ok_new if early_term else done
            return it + 1, c2v_flat, post_pad, hard, done, iters

        carry = (jnp.int32(0), c2v0, post0, hard0, done0, iters0)
        if early_term:
            def cond(carry):
                it, *_, done, _ = carry
                return (it < max_iter) & ~jnp.all(done)
            carry = jax.lax.while_loop(cond, body, carry)
        else:
            carry = jax.lax.fori_loop(0, max_iter, lambda _, c: body(c), carry)
        _, _, post_pad, hard, done, iters = carry
        if early_term:
            conv = done
        else:
            conv = _syndrome_ok(
                jnp.pad(hard.astype(jnp.int32), ((0, 0), (0, 1))), ev)
        return hard.astype(jnp.uint8), iters, conv

    return decode


def make_decoder(code: LDPCCode, dec: DecoderConfig, quant: QuantConfig):
    """Factory from configs (SURVEY.md §5.6)."""
    if dec.algorithm not in ("min-sum", "offset-min-sum",
                             "normalized-min-sum"):
        raise ValueError(f"jnp reference decoder supports min-sum family, "
                         f"got {dec.algorithm}")
    from ..config import cn_params
    beta, alpha = cn_params(dec, quant)
    maker = (make_layered_decoder if dec.schedule == "layered"
             else make_flooding_decoder)
    return maker(code, max_iter=dec.max_iter, beta=beta, qmax=quant.qmax,
                 early_term=dec.early_term, alpha=alpha)


# ---------------------------------------------------------------------------
# Float decoders — the framework-side counterpart of the reference's MATLAB
# float golden model (SURVEY.md §2.1 C12). Used to measure the fixed-point
# "quantization bound": the BER/FER gap between float BP and the 8-bit
# fixed-point decoder (BASELINE.json:5 'within its fixed-point quantization
# bound').
# ---------------------------------------------------------------------------

def _cn_update_float(v2c, mask, algorithm: str, beta: float):
    """Float CN update on dense (..., C, D) messages; pads hold +inf-like."""
    big = jnp.float32(1e30)
    if algorithm == "sum-product":
        t = jnp.tanh(jnp.clip(v2c, -30.0, 30.0) / 2.0)
        eps = jnp.float32(1e-12)
        t = jnp.where(jnp.abs(t) < eps, jnp.where(t < 0, -eps, eps), t)
        t = jnp.where(mask, t, 1.0)
        p = jnp.prod(t, axis=-1, keepdims=True)
        r = jnp.clip(p / t, -0.999999, 0.999999)
        out = 2.0 * jnp.arctanh(r)
        return jnp.where(mask, out, 0.0)
    mags = jnp.abs(jnp.where(mask, v2c, big))
    amin = jnp.argmin(mags, axis=-1)[..., None]
    slots = jax.lax.broadcasted_iota(jnp.int32, v2c.shape, v2c.ndim - 1)
    min1 = jnp.min(mags, axis=-1, keepdims=True)
    min2 = jnp.min(jnp.where(slots == amin, big, mags), axis=-1, keepdims=True)
    neg = (v2c < 0) & mask
    par = (jnp.sum(neg, axis=-1, keepdims=True) & 1).astype(bool)
    excl_neg = jnp.logical_xor(par, neg)
    excl_mag = jnp.where(slots == amin, min2, min1)
    if algorithm == "offset-min-sum":
        excl_mag = jnp.maximum(excl_mag - beta, 0.0)
    elif algorithm == "normalized-min-sum":
        # beta carries the float alpha factor for the normalized variant
        excl_mag = excl_mag * beta
    val = jnp.where(excl_neg, -excl_mag, excl_mag)
    return jnp.where(mask, val, 0.0)


def make_layered_float_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    algorithm: str = "sum-product",
    beta: float = 0.5,
    early_term: bool = True,
):
    """Batched LAYERED float BP decoder — the same-schedule float bound for
    layered fixed-point runs (golden decode_float schedule='layered'
    semantics: all checks of a layer read the pre-layer posterior, syndrome
    once per sweep). decode(llr_f32[B, n]) -> (hard u8, iters, conv)."""
    lay = compile_edge_layout(code)
    M, D, N = lay.m, lay.max_dc, lay.n
    DUMP = M * D

    if code.base is not None and code.Z is not None:
        Z = int(code.Z)
        layers = [np.arange(i * Z, (i + 1) * Z, dtype=np.int32)
                  for i in range(code.m // Z)]
    else:
        layers = compile_layers_general(code)
    L = len(layers)
    Cmax = max(len(l) for l in layers)

    lpos = np.full((L, Cmax, D), DUMP, np.int32)
    lev = np.full((L, Cmax, D), N, np.int32)
    lmask = np.zeros((L, Cmax, D), bool)
    for li, checks in enumerate(layers):
        for t, c in enumerate(checks):
            m_ = lay.cn_mask[c]
            lpos[li, t][m_] = c * D + np.nonzero(m_)[0]
            lev[li, t] = lay.ev_dense[c]
            lmask[li, t] = m_
    lpos_j, lev_j, lmask_j = map(jnp.asarray, (lpos, lev, lmask))
    ev = jnp.asarray(lay.ev_dense)

    def decode(chan: jnp.ndarray):
        B = chan.shape[0]
        chan = chan.astype(jnp.float32)
        c2v0 = jnp.zeros((B, M * D + 1), jnp.float32)
        post0 = jnp.pad(chan, ((0, 0), (0, 1)))
        hard0 = chan < 0
        done0 = (_syndrome_ok(
            jnp.pad(hard0.astype(jnp.int32), ((0, 0), (0, 1))), ev)
            if early_term else jnp.zeros(B, bool))
        iters0 = jnp.zeros(B, jnp.int32)

        def layer_body(l, state):
            c2v_flat, post_pad = state
            pos, evl, mk = lpos_j[l], lev_j[l], lmask_j[l]
            c2v_l = c2v_flat[:, pos]
            v2c = post_pad[:, evl] - c2v_l
            new = _cn_update_float(v2c, mk, algorithm, beta)
            delta = jnp.where(mk, new - c2v_l, 0.0)
            post_pad = post_pad.at[:, evl.reshape(-1)].add(
                delta.reshape(B, -1))
            c2v_flat = c2v_flat.at[:, pos.reshape(-1)].set(
                new.reshape(B, -1))
            return c2v_flat, post_pad

        def body(carry):
            it, c2v_flat, post_pad, hard, done, iters = carry
            c2v_new, post_new = jax.lax.fori_loop(
                0, L, layer_body, (c2v_flat, post_pad))
            hard_new = post_new[:, :N] < 0
            ok_new = _syndrome_ok(
                jnp.pad(hard_new.astype(jnp.int32), ((0, 0), (0, 1))), ev)
            c2v_flat = jnp.where(done[:, None], c2v_flat, c2v_new)
            post_pad = jnp.where(done[:, None], post_pad, post_new)
            hard = jnp.where(done[:, None], hard, hard_new)
            iters = iters + (~done).astype(jnp.int32)
            done = done | ok_new if early_term else done
            return it + 1, c2v_flat, post_pad, hard, done, iters

        carry = (jnp.int32(0), c2v0, post0, hard0, done0, iters0)
        if early_term:
            carry = jax.lax.while_loop(
                lambda c: (c[0] < max_iter) & ~jnp.all(c[4]), body, carry)
        else:
            carry = jax.lax.fori_loop(0, max_iter,
                                      lambda _, c: body(c), carry)
        _, _, post_pad, hard, done, iters = carry
        conv = done if early_term else _syndrome_ok(
            jnp.pad(hard.astype(jnp.int32), ((0, 0), (0, 1))), ev)
        return hard.astype(jnp.uint8), iters, conv

    return decode


def make_float_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    algorithm: str = "sum-product",
    beta: float = 0.5,
    early_term: bool = True,
    schedule: str = "flooding",
):
    """Batched float BP decoder: decode(llr_f32[B, n]) ->
    (hard u8, iters i32, converged bool). schedule='layered' dispatches to
    make_layered_float_decoder."""
    if schedule == "layered":
        return make_layered_float_decoder(code, max_iter, algorithm, beta,
                                          early_term)
    if schedule != "flooding":
        raise ValueError(schedule)
    lay = compile_edge_layout(code)
    M, D, N = lay.m, lay.max_dc, lay.n
    ev = jnp.asarray(lay.ev_dense)
    vn_pos = jnp.asarray(lay.vn_pos)
    mask = jnp.asarray(lay.cn_mask)

    def totals(chan, c2v_flat):
        return chan + jnp.sum(c2v_flat[:, vn_pos], axis=-1)

    def pad1(x):
        return jnp.pad(x, ((0, 0), (0, 1)))

    def decode(chan: jnp.ndarray):
        B = chan.shape[0]
        chan = chan.astype(jnp.float32)
        c2v_flat = jnp.zeros((B, M * D + 1), jnp.float32)
        hard0 = chan < 0
        done0 = (_syndrome_ok(pad1(hard0.astype(jnp.int32)), ev)
                 if early_term else jnp.zeros(B, bool))
        iters0 = jnp.zeros(B, jnp.int32)

        def body(carry):
            it, c2v_flat, hard, done, iters = carry
            tot_pad = pad1(totals(chan, c2v_flat))
            c2v_d = c2v_flat[:, : M * D].reshape(B, M, D)
            v2c = tot_pad[:, ev] - c2v_d
            new = _cn_update_float(v2c, mask, algorithm, beta)
            new_flat = pad1(new.reshape(B, M * D))
            tot2 = totals(chan, new_flat)
            hard_new = tot2 < 0
            ok_new = _syndrome_ok(pad1(hard_new.astype(jnp.int32)), ev)
            c2v_flat = jnp.where(done[:, None], c2v_flat, new_flat)
            hard = jnp.where(done[:, None], hard, hard_new)
            iters = iters + (~done).astype(jnp.int32)
            done = done | ok_new if early_term else done
            return it + 1, c2v_flat, hard, done, iters

        carry = (jnp.int32(0), c2v_flat, hard0, done0, iters0)
        if early_term:
            carry = jax.lax.while_loop(
                lambda c: (c[0] < max_iter) & ~jnp.all(c[3]), body, carry)
        else:
            carry = jax.lax.fori_loop(0, max_iter, lambda _, c: body(c), carry)
        _, _, hard, done, iters = carry
        conv = done if early_term else _syndrome_ok(
            pad1(hard.astype(jnp.int32)), ev)
        return hard.astype(jnp.uint8), iters, conv

    return decode
