"""Error-floor estimation by defensive mixture importance sampling.

Plain Monte-Carlo cannot reach the error-floor region (FER 1e-9 needs
~1e10 frames). This module estimates the floor with a MIXTURE importance-
sampling proposal built from trapping sets (analysis/trapping.py): the
AWGN noise mean is shifted toward each candidate set's error region, and
the unshifted channel stays in the mixture with weight pi0, so

  * the estimator is UNBIASED for the true FER regardless of which sets
    were found — a missed error mechanism costs variance, never bias;
  * likelihood weights are bounded by 1/pi0 (q >= pi0 * p pointwise), so
    the worst case is a bounded constant-factor loss vs plain MC, never a
    weight blow-up.

All-zeros transmission (valid: min-sum with symmetric quantization is
sign-symmetric, so the error probability is codeword-independent — the
same argument that justifies RunConfig.all_zeros). BPSK/AWGN only.

Rate matching (punctured/shortened codes — NR, rate_compat ladders) is
modeled with the pipeline's exact contract: the channel, the noise space,
and the mixture mean shifts cover only the n_tx transmitted positions;
punctured VNs enter the decoder at LLR 0 and shortened VNs saturated.
Eb/N0 -> sigma uses the EFFECTIVE rate k_eff/n_tx (code.rate), matching
sim/sweep.py, so floor curves line up with waterfall curves point-for-
point.

Estimator: FER = E_q[ 1{frame error} * p(z)/q(z) ], with
p = N(0, sigma^2 I), q = pi0*p + (1-pi0)/K * sum_k N(mu_k, sigma^2 I),
mu_k = -delta * indicator(S_k). Per-batch sums of w and w^2 leave the
device; the running relative standard error is exact.

Device notes: the chain reuses the framework's channel/quantize ops and
select_decoder's dispatch; the weight computation is one (B, n) x (n, K)
matmul plus a logsumexp, pinned to full float32 precision and negligible
next to decode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..ops import channel as ch
from ..ops.encode import info_positions
from ..ops.quantize import quantize
from .pipeline import select_decoder


def _check_domain(cfg: SimConfig, code=None) -> None:
    del code  # rate matching is modeled natively (see _rate_match)
    if cfg.channel.modulation != "bpsk":
        raise ValueError("importance sampling supports BPSK only")


def _rate_match(code) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(tx_pos, short_pos) mirroring the pipeline's rate-matching contract
    (sim/pipeline.py): punctured VNs are never transmitted and enter the
    decoder with LLR 0; shortened VNs are known zeros and enter saturated
    (+1e6 pre-quantize -> +qmax). The channel — and therefore the IS noise
    space and the mixture mean shifts — covers ONLY the n_tx transmitted
    positions; a trapping set's punctured members receive no shift (there
    is no channel observation to bias there). Returns (None, None) for an
    unpunctured code."""
    if not (len(code.punct_vns) or len(code.shortened_vns)):
        return None, None
    excluded = set(map(int, code.punct_vns)) | set(
        map(int, code.shortened_vns))
    tx_pos = np.asarray([v for v in range(code.n) if v not in excluded],
                        np.int32)
    short_pos = (np.asarray(code.shortened_vns, np.int32)
                 if len(code.shortened_vns) else None)
    return tx_pos, short_pos


def _assemble_llr(z: jnp.ndarray, sigma, code, tx_pos, short_pos,
                  batch: int) -> jnp.ndarray:
    """Channel observations (1 + z over transmitted positions, all-zeros
    codeword) -> full-length float LLR row, pipeline rate-matching rules."""
    llr = ch.demap(1.0 + z, sigma, "bpsk")
    if tx_pos is None:
        return llr
    full = jnp.zeros((batch, code.n), llr.dtype).at[:, jnp.asarray(tx_pos)
                                                    ].set(llr)
    if short_pos is not None:
        full = full.at[:, jnp.asarray(short_pos)].set(jnp.float32(1e6))
    return full


# ---------------------------------------------------------------------------
# Failure harvesting (the empirical source of trapping-set candidates)
# ---------------------------------------------------------------------------

def harvest_error_supports(code, cfg: SimConfig, ebn0_db: float,
                           frames: int = 4096, batch: int = 512,
                           backend: str = "auto", seed: int = 1,
                           max_supports: int = 256) -> List[np.ndarray]:
    """Run plain all-zeros Monte-Carlo and return the error supports
    (positions of nonzero decoded bits) of every failed frame. Harvested
    at a waterfall-floor transition SNR these are the dominant trapping-set
    cores (after analysis.trapping.refine_support)."""
    _check_domain(cfg, code)
    dec, _ = select_decoder(code, cfg, backend, batch=batch)
    sigma = ch.sigma_for(ebn0_db, code.rate, "bpsk")
    tx_pos, short_pos = _rate_match(code)
    n_ch = code.n if tx_pos is None else len(tx_pos)

    # Two-step fetch: only the (B,) failure mask crosses the device->host
    # link every batch; the (n_bad, n) hard bits are gathered on-device and
    # fetched only for failing frames — a (B, n) tensor per call would
    # move ~85 MB to the host at the default harvest sizes.
    @jax.jit
    def run(key):
        z = sigma * jax.random.normal(key, (batch, n_ch))
        llr = _assemble_llr(z, sigma, code, tx_pos, short_pos, batch)
        q = quantize(llr, cfg.quant)
        hard, _, _ = dec(q)
        return hard.any(axis=1), hard

    # FIXED-SHAPE row gather: a dynamic-length index vector would retrace/
    # recompile per distinct failure count.
    # Failures beyond the per-batch cap are dropped — max_supports caps the
    # total anyway, and failure supports are exchangeable samples.
    max_bad = min(64, batch)
    gather = jax.jit(lambda hard, idx: jnp.take(hard, idx, axis=0))
    out: List[np.ndarray] = []
    key = jax.random.PRNGKey(seed)
    for i in range((frames + batch - 1) // batch):
        mask, hard = run(jax.random.fold_in(key, i))
        bad = np.nonzero(np.asarray(mask))[0][:max_bad]
        if not len(bad):
            continue
        idx = np.zeros(max_bad, np.int32)
        idx[:len(bad)] = bad
        rows = np.asarray(gather(hard, jnp.asarray(idx)))[:len(bad)]
        for r in rows:
            out.append(np.nonzero(r)[0].astype(np.int32))
            if len(out) >= max_supports:
                return out
    return out


# ---------------------------------------------------------------------------
# Mixture-IS estimator
# ---------------------------------------------------------------------------

def mixture_log_weight(z: jnp.ndarray, M: jnp.ndarray, sizes: jnp.ndarray,
                       log_pi: jnp.ndarray, delta: float,
                       sigma) -> jnp.ndarray:
    """log p(z)/q(z) for the defensive Gaussian mixture (B,) — the common
    N(.,sigma^2 I) normalizers cancel, so only the mean shifts enter:

      log w = -logsumexp_k[ log pi_k + (2 z.mu_k - |mu_k|^2) / (2 sigma^2) ]

    with mu_0 = 0 and mu_k = -delta * M[k-1]. Bounded above by -log pi_0.
    Exposed for direct numerical testing against a brute-force density
    ratio (tests/test_trapping.py)."""
    sigma = jnp.float32(sigma)
    # (B, K): z . indicator_k. HIGHEST keeps full float32: a GPU may
    # otherwise run a float32 product in TF32 (about three decimal digits),
    # which would bias the weights of a deep-floor estimate.
    s_k = jnp.matmul(z, M.T, precision=jax.lax.Precision.HIGHEST)
    expo = (-2.0 * delta * s_k - (delta ** 2) * sizes) / (2.0 * sigma ** 2)
    terms = jnp.concatenate(
        [jnp.zeros((z.shape[0], 1), jnp.float32), expo], axis=1) + log_pi
    return -jax.scipy.special.logsumexp(terms, axis=1)

@dataclasses.dataclass
class ISEstimate:
    ebn0_db: float
    fer: float                 # importance-sampled FER estimate
    rel_std: float             # relative standard error of fer
    frames: int
    raw_hits: int              # frames that erred under the proposal
    fer_plain_ci95: float      # what plain MC could have resolved: 2/frames
    ber: float                 # importance-sampled info-BER estimate

    def to_dict(self):
        d = dataclasses.asdict(self)
        if not np.isfinite(d["rel_std"]):
            d["rel_std"] = None  # strict-JSON safe (Infinity is not RFC 8259)
        return d


def expand_radial(sets: Sequence[Sequence[int]],
                  deltas: Sequence[float]
                  ) -> Tuple[List[Sequence[int]], np.ndarray]:
    """Radial-ladder proposal: replicate every support at every shift
    depth, as separate mixture components. Returns (sets_expanded,
    delta_vector) for make_is_run/estimate_fer. Covering several radii of
    each basin tames the heavy-tailed weights that a single full-flip
    depth produces deep in the floor (the dominant contribution comes
    from the basin's low-energy boundary — partial flips)."""
    ds = [float(d) for d in deltas]
    if not ds:
        raise ValueError("deltas must be non-empty")
    out_sets: List[Sequence[int]] = []
    out_d: List[float] = []
    for s in sets:
        for d in ds:
            out_sets.append(s)
            out_d.append(d)
    return out_sets, np.asarray(out_d, np.float32)


def _apportion(pis: np.ndarray, total: int, min_each: int = 1) -> np.ndarray:
    """Largest-remainder apportionment of `total` lanes to len(pis) strata,
    each stratum guaranteed >= min_each (an unsampled stratum would bias a
    stratified estimator — every mixture component must appear)."""
    k = len(pis)
    if total < k * min_each:
        raise ValueError(f"batch {total} too small for {k} strata "
                         f"(min {min_each} each)")
    rem_total = total - k * min_each
    p = np.asarray(pis, np.float64)
    quota = p / p.sum() * rem_total
    base = np.floor(quota).astype(np.int64)
    frac = quota - base
    left = int(rem_total - base.sum())
    order = np.argsort(-frac, kind="stable")
    base[order[:left]] += 1
    return (base + min_each).astype(np.int32)


def make_is_run(code, cfg: SimConfig, sets: Sequence[Sequence[int]],
                delta: float = 2.0, pi0: float = 0.5, batch: int = 1024,
                backend: str = "auto",
                mesh=None, stratify: bool = False
                ) -> Callable[[jax.Array, float], jnp.ndarray]:
    """One jitted IS batch: run(key, sigma) -> stacked sums
    [sum w*err, sum (w*err)^2, raw err frames, sum w*bit_errs] (float32).

    sets may be empty: the proposal is then exactly p and every weight is
    1 — the estimator degenerates to plain Monte-Carlo by construction
    (tested; this is the unbiasedness anchor).

    delta: scalar shift depth, or a per-set vector. To build a RADIAL
    LADDER (the deep-floor variance fix), pass each support several times
    with different depths — see expand_radial().

    mesh: optional jax.sharding.Mesh — the frame batch shards over all
    mesh axes like the main pipeline's DP (partitionable threefry keeps
    the SAMPLES identical to the unsharded run; only the f32 summation
    order differs across shards).

    stratify: instead of drawing each lane's mixture component
    multinomially, take run(key, sigma, counts) with a replicated int32
    (K+1,) lane allocation (sum == batch, every entry >= 1) and return the
    per-stratum sums as a (4, K+1) array. The likelihood weights are
    unchanged (still p/q against the FULL mixture q); the host combines
    strata as sum_j pi_j * mean_j, which removes the component-count
    multinomial noise from the estimator (classic stratified IS) and
    enables Neyman allocation without recompiling — counts is a runtime
    argument.
    """
    _check_domain(cfg, code)
    if not 0 < pi0 <= 1:
        raise ValueError(f"pi0 must be in (0, 1], got {pi0}")
    if np.any(np.asarray(delta, np.float32) <= 0):
        raise ValueError("delta (shift depth) must be > 0 per component")
    tx_pos, short_pos = _rate_match(code)
    n_ch = code.n if tx_pos is None else len(tx_pos)
    # delta may be a scalar (one shift depth for every set) or a per-set
    # vector — a RADIAL LADDER: the same support at several depths as
    # separate mixture components. Deep floors need this: the dominant
    # weight mass sits at the basin's low-energy boundary (partial flips),
    # which a single full-flip shift undersamples — measured as seed-to-
    # seed scatter far beyond reported errors at 5.0 dB
    # (results/floor_validate.json) before the ladder existed.
    deltas = np.broadcast_to(np.asarray(delta, np.float32),
                             (len(sets),)).copy()
    if len(sets) and tx_pos is not None:
        # The mixture can only shift transmitted positions. A set whose VNs
        # are all punctured/shortened collapses to the defensive component
        # (zero shift) — drop it rather than waste a mixture slot on a
        # duplicate of p (weights stay exact either way; this is variance
        # hygiene, not a correctness need).
        keep_idx = [i for i, s in enumerate(sets)
                    if len(np.intersect1d(
                        np.asarray(sorted(set(map(int, s))), np.int64),
                        tx_pos))]
        if len(keep_idx) != len(sets):
            import warnings
            warnings.warn(f"importance sampling: dropped "
                          f"{len(sets) - len(keep_idx)} proposal set(s) "
                          "with no transmitted positions (fully "
                          "punctured/shortened)")
            sets = [sets[i] for i in keep_idx]
            deltas = deltas[keep_idx]
    if not sets and pi0 < 1:
        pi0 = 1.0
    K = len(sets)
    dec, dec_label = select_decoder(code, cfg, backend, batch=batch)
    from .pipeline import maybe_shard_map_decoder
    dec = maybe_shard_map_decoder(dec, dec_label, mesh)
    info_pos = jnp.asarray(np.asarray(info_positions(code)))
    if K:
        M = np.zeros((K, code.n), np.float32)
        for k, s in enumerate(sets):
            M[k, np.asarray(sorted(set(map(int, s))), np.int64)] = 1.0
        if tx_pos is not None:
            M = M[:, tx_pos]  # shifts live in the transmitted space only
        # |mu_k|^2 must describe the shift actually applied: count UNIQUE
        # positions (a duplicated index in a caller's set would otherwise
        # silently bias the weights). Depths are folded into the mean
        # matrix (mu_k = -deltas_k * m_k), so the weight kernel runs with
        # delta=1 and per-component |mu_k|^2.
        M = deltas[:, None] * M
        sizes = (deltas ** 2 * (M > 0).sum(axis=1)).astype(np.float32)
        Mj = jnp.asarray(M)
        sizes_j = jnp.asarray(sizes)
        log_pi = jnp.log(jnp.concatenate(
            [jnp.asarray([pi0], jnp.float32),
             jnp.full((K,), (1.0 - pi0) / K, jnp.float32)]))
    else:
        Mj = sizes_j = log_pi = None

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if batch % mesh.size:
            raise ValueError(f"batch {batch} not divisible by mesh size "
                             f"{mesh.size}")

        def shard_b(x):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(mesh.axis_names,
                                         *([None] * (x.ndim - 1)))))
    else:
        def shard_b(x):
            return x

    stratified = bool(stratify) and K > 0

    def run(key: jax.Array, sigma, counts=None) -> jnp.ndarray:
        sigma = jnp.float32(sigma)
        kc, kn = jax.random.split(key)
        eps = shard_b(jax.random.normal(kn, (batch, n_ch), jnp.float32))
        z = sigma * eps
        if K:
            if stratified:
                # deterministic lane blocks: lanes [0, counts[0]) are the
                # defensive component, the next counts[1] are set 1, ...
                comp = jnp.searchsorted(jnp.cumsum(counts),
                                        jnp.arange(batch), side="right"
                                        ).astype(jnp.int32)
            else:
                # component per lane: 0 = unshifted, 1..K = sets
                comp = jax.random.categorical(
                    kc, jnp.broadcast_to(log_pi, (batch, K + 1)), axis=-1)
            # depths are folded into Mj rows (mu_k = -deltas_k * m_k), so
            # the shift is the row itself and the weight kernel runs at
            # delta=1 with per-component |mu_k|^2 in sizes_j
            shift_row = jnp.where(comp[:, None] > 0,
                                  -Mj[jnp.maximum(comp - 1, 0)], 0.0)
            z = z + shift_row
            w = jnp.exp(mixture_log_weight(z, Mj, sizes_j, log_pi, 1.0,
                                           sigma))
        else:
            w = jnp.ones((batch,), jnp.float32)
        llr = _assemble_llr(z, sigma, code, tx_pos, short_pos, batch)
        q = quantize(llr, cfg.quant)
        hard, _, _ = dec(q)
        info_err = hard[:, info_pos] != 0
        err = jnp.any(info_err, axis=-1).astype(jnp.float32)
        bits = jnp.sum(info_err, axis=-1).astype(jnp.float32)
        we = w * err
        if stratified:
            seg = lambda v: jax.ops.segment_sum(  # noqa: E731
                v, comp, num_segments=K + 1)
            return jnp.stack([seg(we), seg(we * we), seg(err),
                              seg(w * bits)])
        return jnp.stack([jnp.sum(we), jnp.sum(we * we), jnp.sum(err),
                          jnp.sum(w * bits)])

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        repl = NamedSharding(mesh, P())
        ins = (repl, repl) + ((repl,) if stratified else ())
        out = jax.jit(run, in_shardings=ins, out_shardings=repl)
    else:
        out = jax.jit(run)
    out.batch = batch  # estimate_fer validates against its own accounting
    out.stratified = stratified
    out.n_comp = K + 1
    out.pis = (np.concatenate([[pi0], np.full(K, (1.0 - pi0) / K)])
               if K else np.ones(1))
    return out


def canonical_rotation(code, support: Sequence[int]) -> Tuple[int, ...]:
    """Rotate a QC-code support to its canonical orbit representative: the
    lexicographically smallest of its Z rotations (rotation r maps
    b*Z + o -> b*Z + (o + r) % Z). Dedup key for orbit folding."""
    Z = int(code.Z)
    s = np.asarray(sorted(set(map(int, support))), np.int64)
    blocks, offs = s // Z, s % Z
    best = None
    for r in range(Z):
        cand = tuple(sorted(blocks * Z + (offs + r) % Z))
        if best is None or cand < best:
            best = cand
    return best


def make_symmetric_run(code, cfg: SimConfig, reps: Sequence[Sequence[int]],
                       delta=2.0, pi0: float = 0.25, batch: int = 1024,
                       backend: str = "auto",
                       mesh=None):
    """Symmetry-folded mixture IS (round 5 — the DVB-S2 deep-floor fix).

    A QC code + iid channel + all-zeros transmission is bit-exactly
    invariant under the Z circulant rotations, so every failure mechanism
    comes in an orbit of Z equally-likely rotations. Round-4's mixture
    covered a HANDFUL of specific rotations out of tens of thousands
    (e.g. 24 of ~30k accumulator chains), leaving ~99.9% of the
    mechanism's mass reachable only through the defensive component —
    measured as seed-to-seed scatter of decades with single near-max-
    weight hits (results/dvb_floor5*.json), and falsified outright by the
    deep plain-MC probe (results/dvb_mc_deep.json).

    Here the proposal covers ONE canonical representative per orbit
    (expand_radial over `reps`), and the estimator Z-folds with an EXACT
    multiplicity correction. Per failing frame, let match(k, r) = 1 iff
    the error support intersects rotation r of representative k,
    M = sum_{k,r} match(k,r) and M0_k = match(k, 0). Because M is
    rotation-invariant and the ensemble is rotation-symmetric,

        Z * E_q[w * fail * M0_k / M]  =  sum_r E_q[w * fail *
                                          match(k,r) / M]

    for every k, so

        FER = Z * sum_k E_q[w*fail*M0_k/M] + E_q[w*fail*1{M=0}]

    holds EXACTLY — no union bound, no support-size gate: a failure
    intersecting several representatives/rotations is fractionally
    shared and never double-counted (the naive gate-based Z-fold
    measured 2x high against plain IS on the toy code at every SNR; the
    M0/M form matches it within errors). The first term is the
    low-variance Z-folded structured component (events near the
    canonical representatives, which the proposal boosts); the remainder
    is defensive (plain-MC-grade variance — resolvable at anchor SNRs,
    ~zero mass deep). Convergence is judged by SEED REPEATABILITY plus
    agreement with direct MC anchors, never rel_std alone.

    run(key, sigma) -> (4, K+2) float32 device array. Columns 0..K-1:
    per-representative Z-folded shares; column K: unmatched remainder;
    column K+1: totals. Rows = [sum xi (the per-frame FER contribution),
    sum xi^2, raw fail counts, sum w*anyfail]."""
    _check_domain(cfg, code)
    if code.Z is None:
        raise ValueError("symmetric IS requires a QC code")
    if not reps:
        raise ValueError("need at least one orbit representative")
    Z = int(code.Z)
    K = len(reps)
    # Rate matching (NR): same pipeline contract as make_is_run — the
    # channel/noise/shifts cover only transmitted positions. Rotation
    # symmetry additionally requires the punctured/shortened pattern to
    # be BLOCK-aligned (whole Z-blocks; bit-granular patterns break the
    # orbit equivalence the Z-fold rests on) — qc_block_cover raises for
    # partial blocks, which is exactly the gate needed here.
    tx_pos, short_pos = _rate_match(code)
    if tx_pos is not None:
        from ..codes.code import qc_block_cover
        qc_block_cover(code.punct_vns, Z, "punctured")
        qc_block_cover(code.shortened_vns, Z, "shortened")
    n_ch = code.n if tx_pos is None else len(tx_pos)
    deltas = np.broadcast_to(np.asarray(delta, np.float32), (K,)).copy()
    dec, dec_label = select_decoder(code, cfg, backend, batch=batch)
    from .pipeline import maybe_shard_map_decoder
    dec = maybe_shard_map_decoder(dec, dec_label, mesh)

    info_pos = jnp.asarray(np.asarray(info_positions(code)))
    nb_blocks = code.n // Z
    M = np.zeros((K, code.n), np.float32)
    rep_pos: List[List[Tuple[int, int]]] = []  # [(block, offset)] per rep
    for k, s in enumerate(reps):
        idx = np.asarray(sorted(set(map(int, s))), np.int64)
        M[k, idx] = deltas[k]
        rep_pos.append([(int(v) // Z, int(v) % Z) for v in idx])
    if tx_pos is not None:
        M = M[:, tx_pos]  # shifts live in the transmitted space only
    sizes = (deltas ** 2 * (M > 0).sum(axis=1)).astype(np.float32)
    Mj = jnp.asarray(M)
    sizes_j = jnp.asarray(sizes)
    log_pi = jnp.log(jnp.concatenate(
        [jnp.asarray([pi0], jnp.float32),
         jnp.full((K,), (1.0 - pi0) / K, jnp.float32)]))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if batch % mesh.size:
            raise ValueError(f"batch {batch} not divisible by mesh size "
                             f"{mesh.size}")

        def shard_b(x):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(mesh.axis_names,
                                         *([None] * (x.ndim - 1)))))
    else:
        def shard_b(x):
            return x

    # Mj rides as a runtime ARGUMENT, not a closure constant: baked into
    # the HLO as a literal, a DVB-sized mixture (1389 x 64800 f32 =
    # 360 MB) blows the remote compiler's request limit (HTTP 413)
    def run_inner(key: jax.Array, sigma, Mj) -> jnp.ndarray:
        sigma = jnp.float32(sigma)
        kc, kn = jax.random.split(key)
        z = sigma * shard_b(jax.random.normal(kn, (batch, n_ch),
                                              jnp.float32))
        comp = jax.random.categorical(
            kc, jnp.broadcast_to(log_pi, (batch, K + 1)), axis=-1)
        shift_row = jnp.where(comp[:, None] > 0,
                              -Mj[jnp.maximum(comp - 1, 0)], 0.0)
        z = z + shift_row
        w = jnp.exp(mixture_log_weight(z, Mj, sizes_j, log_pi, 1.0, sigma))
        llr = _assemble_llr(z, sigma, code, tx_pos, short_pos, batch)
        q = quantize(llr, cfg.quant)
        hard, _, _ = dec(q)
        hard_f = hard.astype(jnp.float32)
        fail_any = (jnp.sum(hard_f, axis=1) > 0).astype(jnp.float32)
        info_err = hard[:, info_pos] != 0
        fail = jnp.any(info_err, axis=-1).astype(jnp.float32)
        # multiplicity machinery: hb[b, o] over blocks; for rep k, the
        # rotation-match profile mr_k[r] = OR over rep positions (b, o)
        # of hb[b, (o + r) % Z] — jnp.roll by -o puts rotation r at
        # index r. m_k = #matching rotations; M = sum_k m_k (rotation-
        # invariant); M0_k = mr_k[0].
        hb = hard.reshape(batch, nb_blocks, Z) != 0
        m0_cols = []
        Mtot = jnp.zeros((batch,), jnp.float32)
        for pos in rep_pos:
            mr = None
            for (b, o) in pos:
                row = hb[:, b, :]
                if o:
                    row = jnp.roll(row, -o, axis=1)
                mr = row if mr is None else (mr | row)
            Mtot = Mtot + jnp.sum(mr.astype(jnp.float32), axis=1)
            m0_cols.append(mr[:, 0].astype(jnp.float32))
        m0 = jnp.stack(m0_cols, axis=1)                     # (B, K)
        inv_M = jnp.where(Mtot > 0, 1.0 / jnp.maximum(Mtot, 1.0), 0.0)
        we = w * fail
        share = we[:, None] * m0 * inv_M[:, None] * jnp.float32(Z)
        rem = we * (Mtot == 0)
        xi = share.sum(axis=1) + rem        # per-frame FER contribution
        cols = jnp.concatenate([share, rem[:, None], xi[:, None]], axis=1)
        raw = jnp.concatenate(
            [fail[:, None] * (m0 > 0), (fail * (Mtot == 0))[:, None],
             fail[:, None]], axis=1)
        anyc = jnp.concatenate(
            [(w * fail_any)[:, None] * (m0 > 0),
             (w * fail_any * (Mtot == 0))[:, None],
             (w * fail_any)[:, None]], axis=1)
        return jnp.stack([cols.sum(axis=0), (cols * cols).sum(axis=0),
                          raw.sum(axis=0), anyc.sum(axis=0)])

    jit_inner = jax.jit(run_inner)
    M_dev = jax.device_put(Mj)  # uploaded once, reused every batch

    def out_run(key, sigma):
        return jit_inner(key, sigma, M_dev)

    out_run.batch = batch
    out_run.K = K
    out_run.orbit_multiplier = Z
    return out_run


def estimate_fer_symmetric(code, cfg: SimConfig,
                           reps: Sequence[Sequence[int]], ebn0_db: float,
                           frames: int, delta=2.0, pi0: float = 0.25,
                           batch: int = 1024, backend: str = "auto",
                           seed: int = 0,
                           mesh=None, run: Optional[Callable] = None
                           ) -> dict:
    """Symmetry-folded FER estimate at one SNR (see make_symmetric_run).
    Returns a dict: fer (Z-folded total), rel_std, the per-orbit top
    contributions, the unattributed remainder and its rel_std, raw hit
    counts, frames."""
    if run is None:
        run = make_symmetric_run(code, cfg, reps, delta=delta, pi0=pi0,
                                 batch=batch, backend=backend,
                                 mesh=mesh)
    batch = run.batch
    K, Z = run.K, run.orbit_multiplier
    sigma = ch.sigma_for(ebn0_db, code.rate, "bpsk")
    nb = (frames + batch - 1) // batch
    key = jax.random.fold_in(jax.random.PRNGKey(seed),
                             int(round(ebn0_db * 1000)) & 0x7FFFFFFF)
    acc = np.zeros((4, K + 2), np.float64)
    for i in range(nb):
        acc += np.asarray(run(jax.random.fold_in(key, i), sigma),
                          np.float64)
    N = nb * batch
    mean = acc[0] / N                      # columns already Z-folded
    var = np.maximum(acc[1] / N - mean ** 2, 0.0) / N
    fer = float(mean[K + 1])               # exact total (xi column)
    rel = (float(np.sqrt(var[K + 1]) / fer) if fer > 0 else float("inf"))
    fer_rem = float(mean[K])
    order = np.argsort(-mean[:K])
    return {
        "ebn0_db": float(ebn0_db), "fer": fer, "rel_std": rel,
        "fer_attributed_zfold": float(mean[:K].sum()),
        "fer_unattributed": fer_rem,
        "rel_std_unattributed": (float(np.sqrt(var[K]) / fer_rem)
                                 if fer_rem > 0 else None),
        "raw_hits": int(acc[2, K + 1]),
        "raw_hits_attributed": int(acc[2, :K].sum()),
        "frames": int(N), "orbit_multiplier": int(Z),
        "fer_plain_ci95": 2.0 / N,
        "top_orbits": [{"rep": int(k), "zfold_fer": float(mean[k]),
                        "raw": int(acc[2, k])}
                       for k in order[:8] if mean[k] > 0],
    }


def estimate_fer(code, cfg: SimConfig, sets: Sequence[Sequence[int]],
                 ebn0_db: float, frames: int, delta: float = 2.0,
                 pi0: float = 0.5, batch: int = 1024,
                 backend: str = "auto", seed: int = 0,
                 mesh=None,
                 run: Optional[Callable] = None,
                 stratify: bool = False,
                 allocation: str = "proportional",
                 pilot_frames: int = 0) -> ISEstimate:
    """Mixture-IS FER estimate at one SNR point. `frames` is rounded up to
    whole batches. Pass a prebuilt `run` (make_is_run) to amortize compiles
    across SNR points.

    stratify: use deterministic per-component lane allocation (see
    make_is_run) — removes the multinomial component-count noise, the
    principled fix for crossover-region variance. allocation:
      "proportional" — counts follow the mixture probabilities pi_j;
      "neyman"       — a pilot phase (pilot_frames, proportional) measures
                       each stratum's std of w*err, then the main phase
                       allocates counts ~ pi_j * std_j (each stratum kept
                       >= 1 lane). The pilot is EXCLUDED from the estimate,
                       so the reported figure stays strictly unbiased
                       (pooling would make sample counts depend on sample
                       values); `frames` counts the main phase only.
    """
    if allocation not in ("proportional", "neyman"):
        raise ValueError(f"unknown allocation {allocation!r}")
    if run is None:
        run = make_is_run(code, cfg, sets, delta=delta, pi0=pi0, batch=batch,
                          backend=backend, mesh=mesh,
                          stratify=stratify)
    elif getattr(run, "batch", batch) != batch:
        # a prebuilt run sums over ITS batch size; silently dividing by a
        # different N would scale every reported rate
        batch = run.batch
    stratified = getattr(run, "stratified", False)
    sigma = ch.sigma_for(ebn0_db, code.rate, "bpsk")
    nb = (frames + batch - 1) // batch
    # fold the SNR point into the stream so a floor curve's points are
    # statistically independent (the pipeline's fold_in(seed, snr) contract)
    key = jax.random.fold_in(jax.random.PRNGKey(seed),
                             int(round(ebn0_db * 1000)) & 0x7FFFFFFF)

    if not stratified:
        sw = sw2 = raw = swb = 0.0
        for i in range(nb):
            out = np.asarray(run(jax.random.fold_in(key, i), sigma),
                             np.float64)
            sw += out[0]
            sw2 += out[1]
            raw += out[2]
            swb += out[3]
        N = nb * batch
        fer = sw / N
        var = max(sw2 / N - fer ** 2, 0.0) / N
        rel = float(np.sqrt(var) / fer) if fer > 0 else float("inf")
        return ISEstimate(ebn0_db=float(ebn0_db), fer=float(fer),
                          rel_std=rel, frames=int(N), raw_hits=int(raw),
                          fer_plain_ci95=2.0 / N,
                          ber=float(swb / (N * code.k_eff)))

    pis = np.asarray(run.pis, np.float64)
    nc = run.n_comp
    counts = _apportion(pis, batch)
    ib = 0  # batch counter shared across phases -> distinct keys everywhere
    if allocation == "neyman" and pilot_frames > 0:
        npb = (pilot_frames + batch - 1) // batch
        acc = np.zeros((4, nc), np.float64)
        cj = jnp.asarray(counts)
        for _ in range(npb):
            acc += np.asarray(run(jax.random.fold_in(key, ib), sigma, cj),
                              np.float64)
            ib += 1
        n_j = counts.astype(np.float64) * npb
        mean_j = acc[0] / n_j
        std_j = np.sqrt(np.maximum(acc[1] / n_j - mean_j ** 2, 0.0))
        alloc_w = pis * std_j
        if alloc_w.sum() > 0:
            counts = _apportion(alloc_w, batch)

    acc = np.zeros((4, nc), np.float64)
    cj = jnp.asarray(counts)
    for _ in range(nb):
        acc += np.asarray(run(jax.random.fold_in(key, ib), sigma, cj),
                          np.float64)
        ib += 1
    n_j = counts.astype(np.float64) * nb
    mean_j = acc[0] / n_j
    var_j = np.maximum(acc[1] / n_j - mean_j ** 2, 0.0)
    fer = float(np.sum(pis * mean_j))
    var = float(np.sum(pis ** 2 * var_j / n_j))
    rel = float(np.sqrt(var) / fer) if fer > 0 else float("inf")
    N = nb * batch
    return ISEstimate(ebn0_db=float(ebn0_db), fer=fer, rel_std=rel,
                      frames=int(N), raw_hits=int(acc[2].sum()),
                      fer_plain_ci95=2.0 / N,
                      ber=float(np.sum(pis * acc[3] / n_j) / code.k_eff))
