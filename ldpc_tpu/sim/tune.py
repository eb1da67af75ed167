"""Auto-tuned two-phase early termination (round-3 VERDICT item 6).

Two-phase ET (sim/pipeline.make_two_phase_decoder) is the scheme that lets
per-lane early termination save wall time on a batch, but a mistuned
(phase1_iters, capacity) split can be slower than fixed iterations. This
module derives
(phase1_iters, phase2_frac) per SNR point from a cheap convergence-CDF
probe batch at sweep start, so a user never pays a regression for not
knowing the tuning rule. DecoderConfig.phase1_iters = -1 selects it
(Sweep.run wires the probe; fused sweeps keep single-phase — mixed SNRs
share one compiled program, so per-point phase splits don't apply).

Exactness is free: two-phase restarts are bit-exact replays (integer
min-sum is deterministic), so tuning only ever changes WALL TIME, never
counters — tests assert sweep-result equality against single-phase.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# Snap candidates so a sweep compiles at most a handful of two-phase
# variants (each (p1, cap) pair is its own XLA program to compile).
P1_CANDIDATES = (2, 3, 4, 5, 6, 8, 10, 12, 16)
CAP_QUANTUM = 1.0 / 16.0


def pick_two_phase(iters_sample, max_iter: int, tile_frac: float,
                   safety: float = 1.6, margin: float = 0.9,
                   ) -> Tuple[Optional[int], Optional[float]]:
    """Choose (phase1_iters, phase2_frac) from sampled per-lane
    first-convergence iteration counts (unconverged lanes report
    max_iter and count as unconverged at every t < max_iter).

    Cost model, in per-lane iterations (decode time is ~linear in
    iterations x lanes; tile effects ride the tile_frac floor):

        cost(t) = t + max_iter * cap(t)
        cap(t)  = min(0.5, max(safety * q(t) + 3 sigma_binomial, tile_frac))

    where q(t) is the sampled unconverged fraction after t iterations.
    The safety factor + binomial slack keep the overflow fallback (which
    costs a full-batch decode) rare across batches drawn from the same
    operating point. Returns (None, None) unless the best candidate beats
    single-phase by the margin (cost < margin * max_iter) — callers then
    keep the untouched single-phase decoder.
    """
    it = np.asarray(iters_sample)
    N = it.size
    assert N > 0
    best: Tuple[Optional[int], Optional[float]] = (None, None)
    best_cost = margin * float(max_iter)
    for t in P1_CANDIDATES:
        if t >= max_iter:
            break
        q = float(np.mean(it > t))
        slack = 3.0 * math.sqrt(max(q * (1.0 - q), 1.0 / N) / N)
        need = safety * q + slack
        if need > 0.5:
            # capacity cannot safely cover the unconverged fraction: the
            # overflow path decodes the FULL batch (cost t + max_iter,
            # strictly worse than single-phase) — decline this t
            continue
        cap = math.ceil(need / CAP_QUANTUM) * CAP_QUANTUM  # compile cache
        cap = max(cap, tile_frac)
        cost = t + max_iter * cap
        if cost < best_cost:
            best, best_cost = (t, cap), cost
    return best


def make_iter_probe(code, cfg, decoder_backend: str = "auto",
                    batch: int = 2048):
    """Jitted probe(key, sigma) -> per-lane first-convergence iteration
    counts (i32[batch]) through the REAL chain (encode -> modulate ->
    AWGN -> demap -> [rate matching] -> quantize -> single-phase ET
    decode), so the sampled CDF is exactly what the sweep's batches see.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ..ops import channel as ch
    from ..ops.encode import make_encoder
    from ..ops.quantize import quantize
    from .pipeline import is_float_mode, select_decoder

    cfg1 = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, phase1_iters=None))
    dec, _ = select_decoder(code, cfg1, decoder_backend)
    enc = make_encoder(code)
    mod = cfg.channel.modulation
    float_mode = is_float_mode(cfg)
    excluded = set(map(int, code.punct_vns)) | set(
        map(int, code.shortened_vns))
    punctured = bool(excluded)
    if punctured:
        tx_pos = jnp.asarray(
            [v for v in range(code.n) if v not in excluded], jnp.int32)
        short_pos = (jnp.asarray(code.shortened_vns)
                     if len(code.shortened_vns) else None)

    def probe(key, sigma):
        kinfo, knoise = jax.random.split(key)
        info = jax.random.bernoulli(
            kinfo, 0.5, (batch, code.k)).astype(jnp.uint8)
        cw = enc(info)
        tx = cw[:, tx_pos] if punctured else cw
        y = ch.awgn(knoise, ch.modulate(tx, mod), sigma)
        llr = ch.demap(y, sigma, mod)
        if punctured:
            full = jnp.zeros((batch, code.n), llr.dtype).at[:, tx_pos].set(llr)
            if short_pos is not None:
                full = full.at[:, short_pos].set(jnp.float32(1e6))
            llr = full
        q = (llr.astype(jnp.float32) if float_mode
             else quantize(llr, cfg.quant))
        _, iters, conv = dec(q)
        # unconverged lanes must count as "beyond t" for every t < max_iter
        return jnp.where(conv, iters, jnp.int32(cfg.decoder.max_iter))

    return jax.jit(probe)
