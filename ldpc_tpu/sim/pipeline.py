"""The jitted end-to-end simulation step (SURVEY.md §3.1 'NEW FRAMEWORK').

The reference's per-frame chain encode -> bpsk -> awgn -> demap -> quantize ->
decode -> count (its main() hot path) is compiled here into ONE XLA program per
chip over a sharded codeword batch. Only five scalar counters leave the device
per superbatch — the psum the survey names (BASELINE.json:5) is inserted by
XLA when the replicated scalar outputs are reduced from the batch-sharded
tensors.

Determinism contract (SURVEY.md §4.2 'Distributed'): the threefry RNG is run
in partitionable mode, so the SAME seed produces the SAME counters on a
1-device and an 8-device mesh — each chip generates exactly its shard of the
global random stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codes.code import LDPCCode
from ..config import SimConfig
from ..ops import channel as ch
from ..ops.decode_ref import make_decoder as make_jnp_decoder
from ..ops.encode import info_positions, make_encoder
from ..ops.quantize import quantize

jax.config.update("jax_threefry_partitionable", True)


FLOAT_ALGOS = ("sum-product", "min-sum-float", "offset-min-sum-float",
               "normalized-min-sum-float")


def is_float_mode(cfg: SimConfig) -> bool:
    """Float decoding (the reference's MATLAB golden path): no quantizer, the
    float BP decoder consumes raw LLRs (SURVEY.md §2.1 C12)."""
    return cfg.decoder.algorithm in FLOAT_ALGOS


def maybe_shard_map_decoder(dec, dec_label: str, mesh):
    """Wrap the CUDA decode kernel in shard_map when a mesh is given: the
    SPMD partitioner treats a foreign call as opaque and would gather and
    replicate around it; shard_map runs it on each device's local batch
    shard — bit-identical (lanes are independent) and collective-free until
    the counter sums. Returns dec unchanged when not applicable. The
    decoder's batch_tile attribute is preserved (the two-phase tuner reads
    it)."""
    if mesh is None or dec_label != "qc-cuda":
        return dec
    axes = mesh.axis_names

    def wrapped(q):
        return jax.shard_map(
            dec, mesh=mesh, in_specs=P(axes, None),
            out_specs=(P(axes, None), P(axes), P(axes)),
            check_vma=False)(q)

    wrapped.batch_tile = dec.batch_tile
    return wrapped


def auto_backend(code: LDPCCode, dec_cfg, quant) -> str:
    """The decode path chosen from what the program can see: the CUDA
    kernel for a QC code whose state fits a thread block when the backend
    is a GPU (the only place it compiles), the QC-structured XLA decoder for
    other QC codes, the edge-gather decoder for codes without QC structure."""
    if code.base is None or code.Z is None:
        return "jnp"
    from ..kernels import minsum_cuda
    if (jax.default_backend() == "gpu"
            and minsum_cuda.fits(code, dec_cfg, quant)):
        return "qc-cuda"
    return "qc-jnp"


def select_decoder(code: LDPCCode, cfg: SimConfig, backend: str = "auto",
                   batch: Optional[int] = None):
    """Decoder dispatch -> (decode, label). backend "auto" resolves through
    auto_backend; "qc-cuda", "qc-jnp" and "jnp" name a decoder. Float
    algorithms always use the jnp float decoder; min* runs on qc-jnp.

    When cfg.decoder.phase1_iters is set (and early_term, and the caller
    supplies `batch`), the returned decoder is the two-phase repacking
    wrapper (make_two_phase_decoder) around the chosen backend."""
    # Accept our own emitted labels as backend requests: Sweep resolves the
    # backend once and feeds the LABEL back into make_run_batch so the
    # plain/fused builds agree; the "-2phase" suffix is re-derived from cfg.
    if backend.endswith("-2phase"):
        backend = backend[: -len("-2phase")]
    if is_float_mode(cfg):
        from ..ops.decode_ref import make_float_decoder
        alg = cfg.decoder.algorithm.replace("-float", "")
        if alg == "normalized-min-sum":
            # the float NMS factor rides the beta slot (see _cn_update_float)
            beta_f = cfg.quant.alpha_num / (1 << cfg.quant.alpha_shift)
        else:
            beta_f = cfg.quant.beta_lsb / cfg.quant.scale  # LLR-domain offset
        return make_float_decoder(
            code, max_iter=cfg.decoder.max_iter, algorithm=alg, beta=beta_f,
            early_term=cfg.decoder.early_term,
            schedule=cfg.decoder.schedule), "jnp-float"
    if backend not in ("auto", "jnp-float", "qc-cuda", "qc-jnp", "jnp"):
        raise ValueError(f"unknown decoder backend {backend!r}")

    def build(dec_cfg):
        """Decoder for an arbitrary DecoderConfig on the resolved backend."""
        b = backend
        if b in ("auto", "jnp-float"):
            b = auto_backend(code, dec_cfg, cfg.quant)
        if dec_cfg.algorithm == "min-star":
            if code.base is None or code.Z is None:
                raise ValueError("min-star requires a QC code")
            b = "qc-jnp"  # the only decoder with the min* CN update
        if b == "qc-cuda":
            if jax.default_backend() != "gpu":
                raise ValueError("the qc-cuda decoder runs only on a GPU")
            from ..kernels import minsum_cuda
            return minsum_cuda.make_decoder(code, dec_cfg, cfg.quant), b
        if b == "qc-jnp":
            from ..ops.decode_qc import make_decoder as make_qc
            return make_qc(code, dec_cfg, cfg.quant), b
        return make_jnp_decoder(code, dec_cfg, cfg.quant), "jnp"

    dec, label = build(cfg.decoder)
    p1 = cfg.decoder.phase1_iters
    # phase1_iters == -1 is the AUTO sentinel (sim/tune.py): the Sweep
    # driver probes the convergence CDF per SNR point and rebuilds with an
    # explicit (p1, cap); a direct build treats it as single-phase.
    if (p1 and p1 > 0 and cfg.decoder.early_term and batch
            and p1 < cfg.decoder.max_iter):
        import dataclasses
        dec_p1, _ = build(dataclasses.replace(cfg.decoder, max_iter=p1))
        # capacity: phase2_frac of the batch, rounded up to the decoder's
        # batch-tile granularity (a partial tile would decode padding).
        g = getattr(dec, "batch_tile", 1)
        want = max(int(batch * cfg.decoder.phase2_frac), g)
        cap = min(batch, -(-want // g) * g)
        tp = make_two_phase_decoder(dec_p1, dec, cap)
        tp.batch_tile = g
        return tp, label + "-2phase"
    return dec, label


def make_two_phase_decoder(dec_p1, dec_full, capacity: int):
    """Two-phase early termination.

    A single straggler lane keeps a whole batch (or kernel tile) iterating
    to max_iter, so per-lane early termination alone saves little wall
    time. Instead:

      phase 1: dec_p1 (ET decoder, few iterations) on the full batch —
               latches every lane that converges early;
      repack:  gather the unconverged lanes into a `capacity`-lane batch
               (static shape; jnp.nonzero with size=);
      phase 2: dec_full (ET decoder, full max_iter) on the compacted batch,
               RESTARTING from channel LLRs — bit-exact because integer
               min-sum is deterministic: the restart replays the identical
               iteration trajectory, so hard bits, convergence flags, and
               first-success iteration counts equal the single-phase run;
      overflow: if more than `capacity` lanes are unconverged (wrong
               operating point), fall back to dec_full on the whole batch
               via lax.cond — still exact, just not faster.

    Gather fill positions point at a padding row appended to the batch, so
    scatter-back indices for REAL lanes are unique (no write races).
    """
    def decode(q: jnp.ndarray):
        B = q.shape[0]
        h1, it1, cv1 = dec_p1(q)
        uncv = jnp.logical_not(cv1)
        n_uncv = jnp.sum(uncv, dtype=jnp.int32)

        def two_phase(_):
            # fill entries index the padding row B — harmless gather, and
            # their scatter writes land on the padding row (sliced off).
            idx = jnp.nonzero(uncv, size=capacity, fill_value=B)[0]
            qpad = jnp.concatenate([q, jnp.zeros((1,) + q.shape[1:],
                                                 q.dtype)], axis=0)
            h2, it2, cv2 = dec_full(qpad[idx])
            hp = jnp.concatenate([h1, jnp.zeros((1,) + h1.shape[1:],
                                                h1.dtype)], axis=0)
            itp = jnp.concatenate([it1, jnp.zeros((1,), it1.dtype)])
            cvp = jnp.concatenate([cv1, jnp.zeros((1,), cv1.dtype)])
            hp = hp.at[idx].set(h2)
            itp = itp.at[idx].set(it2)
            cvp = cvp.at[idx].set(cv2)
            return hp[:B], itp[:B], cvp[:B]

        def full(_):
            return dec_full(q)

        return jax.lax.cond(n_uncv <= capacity, two_phase, full, None)

    decode.capacity = capacity
    return decode


@dataclass(frozen=True)
class BatchCounters:
    """Scalar results of one superbatch (device-reduced)."""
    frames: int
    bit_errs: int        # info-bit errors (the north-star counts info bits)
    frame_errs: int
    iter_sum: int
    converged: int

    def __add__(self, o: "BatchCounters") -> "BatchCounters":
        return BatchCounters(
            self.frames + o.frames, self.bit_errs + o.bit_errs,
            self.frame_errs + o.frame_errs, self.iter_sum + o.iter_sum,
            self.converged + o.converged)

    @staticmethod
    def zero() -> "BatchCounters":
        return BatchCounters(0, 0, 0, 0, 0)


def make_run_batch(
    code: LDPCCode,
    cfg: SimConfig,
    batch: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    decoder_backend: str = "auto",
    n_points: int = 1,
    superbatches: int = 1,
) -> Callable[[jax.Array, jnp.ndarray], Tuple[jnp.ndarray, ...]]:
    """Returns jitted run_batch(key, sigma) -> int32 array (5,) stacking
    (frames, bit_errs, frame_errs, iter_sum, converged). sigma is a traced
    scalar so one compilation covers the whole SNR sweep. With a mesh, the
    batch dimension is sharded over every mesh axis via explicit constraints.

    superbatches > 1 accumulates that many sub-batches inside ONE device
    call (lax.fori_loop over folded sub-keys), so one dispatch carries
    enough work to amortize its fixed cost. Counters sum exactly; the RNG key
    space is (call_key, sub_index), so resume stays sample-exact at call
    granularity.

    n_points > 1 is the fused-SNR-sweep mode (SURVEY.md §2.3 'sweep
    parallelism'): sigma becomes a (n_points,) vector, lane b simulates point
    b % n_points, and every counter comes back with shape (n_points,) — all
    SNR points of a sweep advance inside one sharded device program."""
    B = batch or cfg.run.batch
    mod = cfg.channel.modulation
    enc = make_encoder(code)
    float_mode = is_float_mode(cfg)
    info_pos = jnp.asarray(info_positions(code))
    dec, dec_label = select_decoder(code, cfg, decoder_backend, batch=B)
    dec = maybe_shard_map_decoder(dec, dec_label, mesh)

    # Rate matching (5G NR): punctured variables are never transmitted and
    # enter the decoder with LLR 0; shortened variables are known zeros and
    # enter saturated positive (SURVEY.md §7.1 stage 6).
    punctured = len(code.punct_vns) or len(code.shortened_vns)
    if punctured:
        # n_tx counts the UNION of punctured and shortened positions (heavy
        # NR shortening can overlap the 2Z punctured range; double-counting
        # would bias the Eb/N0 -> sigma calibration).
        excluded = set(map(int, code.punct_vns)) | set(
            map(int, code.shortened_vns))
        n_tx = code.n - len(excluded)
        tx_pos = jnp.asarray(
            [v for v in range(code.n) if v not in excluded], jnp.int32)
        short_pos = (jnp.asarray(code.shortened_vns)
                     if len(code.shortened_vns) else None)
        bps = ch.BITS_PER_SYM[mod]
        if mod != "bpsk" and n_tx % bps:
            raise ValueError(
                f"transmitted length {n_tx} not a multiple of the {mod} "
                f"symbol size ({bps} bits)")
    elif mod != "bpsk" and code.n % ch.BITS_PER_SYM[mod]:
        # without rate matching the whole codeword is transmitted; catch a
        # non-dividing symbol size here instead of a reshape error mid-trace
        raise ValueError(
            f"codeword length {code.n} not a multiple of the {mod} "
            f"symbol size ({ch.BITS_PER_SYM[mod]} bits)")

    if mesh is not None:
        if B % mesh.size:
            raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")
        def shard_b(x):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(mesh.axis_names,
                                         *([None] * (x.ndim - 1)))))
    else:
        def shard_b(x):
            return x

    # Shortened (filler) info bits are known zeros: never random, never in
    # error (their saturated LLR pins the decoder), excluded from k_eff.
    short_info = (np.intersect1d(np.asarray(code.shortened_vns),
                                 np.asarray(info_positions(code)))
                  if len(code.shortened_vns) else None)
    if short_info is not None and len(short_info):
        keep = np.ones(code.k, np.uint8)
        # positions within the info vector (identity for structured codes)
        pos_of = {int(p): i for i, p in enumerate(info_positions(code))}
        keep[[pos_of[int(v)] for v in short_info]] = 0
        keep_j = jnp.asarray(keep)
    else:
        keep_j = None

    if n_points > 1 and B % n_points:
        raise ValueError(f"batch {B} not divisible by n_points {n_points}")

    all_zeros = cfg.run.all_zeros

    def run_batch(key: jax.Array, sigma: jnp.ndarray):
        kinfo, knoise = jax.random.split(key)
        if all_zeros:
            info = shard_b(jnp.zeros((B, code.k), jnp.uint8))
        else:
            info = shard_b(jax.random.bernoulli(
                kinfo, 0.5, (B, code.k)).astype(jnp.uint8))
        if keep_j is not None:
            info = info * keep_j
        if n_points > 1:
            point = jax.lax.rem(
                jax.lax.broadcasted_iota(jnp.int32, (B,), 0), n_points)
            sigma = jnp.asarray(sigma)
            if sigma.shape != (n_points,):
                raise ValueError(f"fused sweep expects sigma of shape "
                                 f"({n_points},), got {sigma.shape}")
            sigma = sigma[point]  # (B,) per-lane noise level
        cw = jnp.zeros((B, code.n), jnp.uint8) if all_zeros else enc(info)
        tx = cw[:, tx_pos] if punctured else cw
        x = ch.modulate(tx, mod)
        y = ch.awgn(knoise, x, sigma)
        llr = ch.demap(y, sigma, mod)
        if punctured:
            full = jnp.zeros((B, code.n), llr.dtype).at[:, tx_pos].set(llr)
            if short_pos is not None:
                full = full.at[:, short_pos].set(jnp.float32(1e6))
            llr = full
        q = shard_b(llr.astype(jnp.float32) if float_mode
                    else quantize(llr, cfg.quant))
        hard, iters, conv = dec(q)
        info_err = hard[:, info_pos] != info
        lane_bits = jnp.sum(info_err, axis=-1, dtype=jnp.int32)
        lane_frame = jnp.any(info_err, axis=-1).astype(jnp.int32)
        # ONE stacked output => one device->host transfer per batch
        if n_points > 1:
            seg = lambda v: jax.ops.segment_sum(  # noqa: E731
                v.astype(jnp.int32), point, num_segments=n_points)
            return jnp.stack([
                jnp.full((n_points,), B // n_points, jnp.int32),
                seg(lane_bits), seg(lane_frame), seg(iters), seg(conv)])
        return jnp.stack([
            jnp.int32(B), jnp.sum(lane_bits), jnp.sum(lane_frame),
            jnp.sum(iters, dtype=jnp.int32),
            jnp.sum(conv, dtype=jnp.int32)])

    if superbatches > 1:
        inner = run_batch

        def run_batch(key: jax.Array, sigma: jnp.ndarray):  # noqa: F811
            def body(i, acc):
                return acc + inner(jax.random.fold_in(key, i), sigma)

            shape = (5, n_points) if n_points > 1 else (5,)
            return jax.lax.fori_loop(
                0, superbatches, body, jnp.zeros(shape, jnp.int32))

    if mesh is not None:
        repl = NamedSharding(mesh, P())
        rb = jax.jit(run_batch, in_shardings=(repl, repl),
                     out_shardings=repl)
    else:
        rb = jax.jit(run_batch)
    # The resolved decoder label rides on the returned callable so callers
    # (Sweep) don't need a second select_decoder build just to learn it.
    rb.backend_label = dec_label
    # resolved decoder tile granularity (the auto two-phase tuner's
    # capacity floor; 1 for the XLA decoders)
    rb.batch_tile = getattr(dec, "batch_tile", 1)
    return rb
