"""QC-structured jnp decoder: the QC min-sum family as pure XLA.

For QC codes the edge-gather decoder (decode_ref.py) wastes memory bandwidth
on large gathers; this decoder works on the QC structure instead —
posteriors as (B, nb, Z) tensors, circulant shifts as static rolls, base
entries unrolled — so XLA lowers it to fused elementwise streams. It is the
production path for codes whose state exceeds a GPU thread block (DVB-S2
n=64800, NR Z=384; SURVEY.md §5.7's device-memory-resident regime), for min*,
and for QC codes off the GPU, and the reference the CUDA kernel
(kernels/minsum_cuda.py) is compared with.

Bit-exact vs golden/decoder.py on identical int8 inputs (same contract as
the kernel; tests assert equality)."""
from __future__ import annotations

from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import LDPCCode
from ..config import DecoderConfig, QuantConfig
from ..codes.layout import qc_entries

_I32 = jnp.int32


def _rot_fwd(x, s):
    """y[..., r] = x[..., (r + s) % Z] (static s)."""
    return x if s == 0 else jnp.roll(x, -s, axis=-1)


def _rot_bwd(x, s):
    return x if s == 0 else jnp.roll(x, s, axis=-1)


def _cn_minsum(v2cs: List[jnp.ndarray], beta: int, alpha=None):
    """Value-exclusion min-sum over a layer's entries ((B, Z) int32 each) —
    identical tie semantics to the golden model (ties by value: |v| == min1
    takes min2, so every tied entry gets min1).
    alpha = (num, shift): normalized-min-sum scaling applied to min1/min2
    before the offset — monotonic, so pre-exclusion application equals the
    golden model's post-exclusion transform."""
    mags = [jnp.abs(v) for v in v2cs]
    min1 = mags[0]
    min2 = jnp.full_like(min1, 1 << 14)
    negpar = v2cs[0] < 0
    for t in range(1, len(v2cs)):
        m = mags[t]
        min2 = jnp.minimum(min2, jnp.maximum(min1, m))
        min1 = jnp.minimum(min1, m)
        negpar = jnp.logical_xor(negpar, v2cs[t] < 0)
    min1_o, min2_o = min1, min2
    if alpha is not None:
        min1_o = jnp.right_shift(min1_o * alpha[0], alpha[1])
        min2_o = jnp.right_shift(min2_o * alpha[0], alpha[1])
    if beta:
        zero = jnp.zeros_like(min1)
        min1_o = jnp.maximum(min1_o - beta, zero)
        min2_o = jnp.maximum(min2_o - beta, zero)
    out = []
    for v, m in zip(v2cs, mags):
        mag = jnp.where(m == min1, min2_o, min1_o)
        out.append(jnp.where(jnp.logical_xor(negpar, v < 0), -mag, mag))
    return out


def _cn_minstar(v2cs: List[jnp.ndarray], thresholds, qmax: int):
    """Min* (approx sum-product) CN update: exclude-self box-plus via
    prefix/suffix combines in entry order — bit-exact mirror of
    golden/decoder._cn_update_minstar (same pinned pairwise semantics:
    per-combine clip to [0, qmax], threshold-LUT correction, +INF
    sentinel identity; entry order == cn_adj ascending-VN order for QC
    codes). Pure compares/adds — vectorizes on any backend."""
    inf = jnp.int32(1 << 14)

    def corr(u):
        c = jnp.zeros_like(u)
        for t in thresholds:
            c = c + (u <= t).astype(_I32)
        return c

    def bp2(x, y):
        ax, ay = jnp.abs(x), jnp.abs(y)
        mag = jnp.minimum(ax, ay) + corr(ax + ay) - corr(jnp.abs(ax - ay))
        mag = jnp.clip(mag, 0, qmax)
        return jnp.where((x < 0) != (y < 0), -mag, mag)

    d = len(v2cs)
    pre = [jnp.full_like(v2cs[0], inf)]
    for i in range(d):
        pre.append(bp2(pre[-1], v2cs[i]))
    suf = [None] * (d + 1)
    suf[d] = jnp.full_like(v2cs[0], inf)
    for j in range(d - 1, -1, -1):
        suf[j] = bp2(v2cs[j], suf[j + 1])
    return [bp2(pre[i], suf[i + 1]) for i in range(d)]


def make_qc_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    schedule: str = "layered",
    early_term: bool = True,
    c2v_dtype=jnp.int8,
    alpha=None,
    minstar=None,
) -> Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """decode(chan_i8[B, n]) -> (hard u8, iters i32, conv bool).
    minstar: threshold tuple (config.minstar_thresholds) selects the min*
    CN update; beta/alpha must be 0/None then."""
    if minstar is not None and (beta or alpha is not None):
        raise ValueError("min-star does not compose with beta/alpha")
    if schedule not in ("flooding", "layered"):
        raise ValueError(schedule)
    qc, layers = qc_entries(code)
    Z, nb = qc.Z, qc.nb
    n = code.n
    entry_of, off = [], 0
    for ents in layers:
        entry_of.append(list(range(off, off + len(ents))))
        off += len(ents)
    n_entries = off
    flooding = schedule == "flooding"

    def syndrome_ok(post):
        """post: (B, nb, Z) -> (B,) bool."""
        unsat = None
        for ents in layers:
            acc = None
            for (j, s) in ents:
                h = (_rot_fwd(post[:, j], s) < 0).astype(_I32)
                acc = h if acc is None else acc ^ h
            u = jnp.sum(acc, axis=-1)
            unsat = u if unsat is None else unsat + u
        return unsat == 0

    def cn_sweep(read_col, c2v, write):
        """One sweep. read_col(j): (B, Z) totals; c2v: (B, n_entries, Z);
        write(j, s, e, old, new, li)."""
        for li, ents in enumerate(layers):
            v2cs, olds = [], []
            for (j, s), e in zip(ents, entry_of[li]):
                old = c2v[:, e].astype(_I32)
                v2cs.append(jnp.clip(_rot_fwd(read_col(j), s) - old,
                                     -qmax, qmax))
                olds.append(old)
            news = (_cn_minstar(v2cs, minstar, qmax)
                    if minstar is not None
                    else _cn_minsum(v2cs, beta, alpha))
            for (j, s), e, old, new in zip(ents, entry_of[li], olds, news):
                write(j, s, e, old, new, li)

    def decode(chan: jnp.ndarray):
        B = chan.shape[0]
        chan3 = chan.astype(_I32).reshape(B, nb, Z)
        c2v0 = jnp.zeros((B, n_entries, Z), c2v_dtype)
        done0 = syndrome_ok(chan3) if early_term else jnp.zeros(B, bool)
        iters0 = jnp.zeros(B, _I32)

        if flooding:
            def body(carry):
                it, tot, c2v, done, iters = carry
                act = ~done
                new_cols = [chan3[:, j] for j in range(nb)]
                new_c2v = c2v

                def write(j, s, e, old, new, li):
                    nonlocal new_cols, new_c2v
                    store = jnp.where(act[:, None], new, old)
                    new_c2v = new_c2v.at[:, e].set(store.astype(c2v_dtype))
                    new_cols[j] = new_cols[j] + _rot_bwd(
                        jnp.where(act[:, None], new, 0), s)

                cn_sweep(lambda j: tot[:, j], c2v, write)
                new_tot = jnp.stack(new_cols, axis=1)
                new_tot = jnp.where(act[:, None, None], new_tot, tot)
                iters = iters + act.astype(_I32)
                done2 = done | syndrome_ok(new_tot) if early_term else done
                return it + 1, new_tot, new_c2v, done2, iters

            init = (jnp.int32(0), chan3, c2v0, done0, iters0)
        else:
            def body(carry):
                it, post, c2v, done, iters = carry
                act = ~done
                new_post, new_c2v = post, c2v

                def write(j, s, e, old, new, li):
                    nonlocal new_post, new_c2v
                    store = jnp.where(act[:, None], new, old)
                    new_c2v = new_c2v.at[:, e].set(store.astype(c2v_dtype))
                    new_post = new_post.at[:, j].add(_rot_bwd(store - old, s))

                cn_sweep(lambda j: new_post[:, j], c2v, write)
                iters = iters + act.astype(_I32)
                done2 = done | syndrome_ok(new_post) if early_term else done
                return it + 1, new_post, new_c2v, done2, iters

            init = (jnp.int32(0), chan3, c2v0, done0, iters0)

        if early_term:
            def cond(c):
                return (c[0] < max_iter) & ~jnp.all(c[3])
            out = jax.lax.while_loop(cond, body, init)
        else:
            out = jax.lax.fori_loop(0, max_iter, lambda _, c: body(c), init)
        _, post, _, done, iters = out
        hard = (post < 0).reshape(B, n).astype(jnp.uint8)
        conv = done if early_term else syndrome_ok(post)
        return hard, iters, conv

    return decode


def make_decoder(code: LDPCCode, dec: DecoderConfig, quant: QuantConfig,
                 c2v_dtype=jnp.int8):
    if dec.algorithm == "min-star":
        from ..config import minstar_thresholds
        return make_qc_decoder(code, max_iter=dec.max_iter, beta=0,
                               qmax=quant.qmax, schedule=dec.schedule,
                               early_term=dec.early_term,
                               c2v_dtype=c2v_dtype,
                               minstar=minstar_thresholds(quant))
    if dec.algorithm not in ("min-sum", "offset-min-sum",
                             "normalized-min-sum"):
        raise ValueError(f"QC jnp decoder supports the min-sum family "
                         f"(+ min-star), got {dec.algorithm}")
    from ..config import cn_params
    beta, alpha = cn_params(dec, quant)
    return make_qc_decoder(code, max_iter=dec.max_iter, beta=beta,
                           qmax=quant.qmax, schedule=dec.schedule,
                           early_term=dec.early_term, c2v_dtype=c2v_dtype,
                           alpha=alpha)
