"""Monte-Carlo BER/FER sweep driver (SURVEY.md §2.1 C11, §3.1).

Replaces the reference's C main(): for each Eb/N0 point, run jitted
superbatches until enough frame errors are collected (or the frame budget is
exhausted), accumulating scalar counters on the host. The per-batch RNG key is
fold_in(fold_in(fold_in(seed, snr_index), batch_index)) so results are
reproducible, mesh-size-invariant (partitionable threefry), and resumable
sample-exactly from a checkpoint (sim/checkpoint.py).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import jax
import numpy as np

from ..codes.code import LDPCCode
from ..config import RETIRED_FIELDS, SimConfig
from ..ops.channel import sigma_for
from . import checkpoint as ckpt
from .pipeline import make_run_batch
from .stats import SnrPoint

log = logging.getLogger("ldpc_tpu.sweep")


@dataclass
class SweepResult:
    config: SimConfig
    code_name: str
    k: int
    n: int
    points: List[SnrPoint] = field(default_factory=list)
    decoder_backend: str = ""

    def rows(self) -> List[Dict]:
        return [p.row(self.k, self.n) for p in self.points]

    def to_json(self) -> str:
        import json
        return json.dumps({
            "config": json.loads(self.config.to_json()),
            "code": self.code_name, "k": self.k, "n": self.n,
            "decoder_backend": self.decoder_backend,
            "results": self.rows(),
        }, indent=1)


def _config_compatible(stored: dict, cfg: SimConfig) -> bool:
    """True when `stored` (the config dict a checkpoint was written with)
    describes the same simulation as `cfg`.

    Exact equality is the base rule, relaxed one way for schema growth:
    a field PRESENT in cfg but ABSENT from the stored dict is accepted
    only at its dataclass default — at the default, the old code's
    behavior is what the default encodes, so the counters are mergeable;
    at any other value the simulation differs and resume must refuse.
    Changed fields refuse; removed fields refuse unless stored at the
    value config.RETIRED_FIELDS says the code now always behaves as.

    Exempt fields (never compared): STOP RULES (run.max_frames,
    run.target_frame_errors) — they bound how long a sweep runs, not what
    it simulates; extending a finished sweep with a bigger budget is the
    canonical resume use case. Mesh shape/axes are exempt too: same-seed
    counters are mesh-size invariant by tested contract
    (test_mesh_size_invariance), so resuming on different hardware is
    sound. Two-phase ET tuning (decoder.phase1_iters/phase2_frac) is
    exempt for the same reason: repacking restarts are bit-exact replays
    (counters identical by tested contract — test_tune.py), so a
    checkpoint written single-phase resumes under -1/auto or an explicit
    split and vice versa."""
    import dataclasses as dc
    import json as _json

    IGNORE = {("run", "max_frames"), ("run", "target_frame_errors"),
              ("run", "mesh_shape"), ("run", "mesh_axes"),
              ("decoder", "phase1_iters"), ("decoder", "phase2_frac")}

    def jsonify(v):
        return _json.loads(_json.dumps(v, default=list))

    def walk(st: dict, obj, section: str = "") -> bool:
        if not isinstance(st, dict):  # corrupted/hand-edited section
            return False
        fields = {f.name: f for f in dc.fields(obj)}
        for k, v in st.items():
            if k not in fields and RETIRED_FIELDS.get((section, k),
                                                      dc.MISSING) != v:
                return False  # field removed since, at another value
        for name, f in fields.items():
            if (section, name) in IGNORE:
                continue
            cur = getattr(obj, name)
            if dc.is_dataclass(cur):
                if not walk(st.get(name, {}), cur, section=name):
                    return False
                continue
            if name in st:
                if jsonify(st[name]) != jsonify(cur):
                    return False
            else:
                default = (f.default if f.default is not dc.MISSING
                           else f.default_factory()
                           if f.default_factory is not dc.MISSING
                           else dc.MISSING)
                if default is dc.MISSING or jsonify(cur) != jsonify(default):
                    return False
        return True

    return walk(stored, cfg)


def _rate_value(rate: str) -> float:
    from fractions import Fraction
    return float(Fraction(rate))


def build_code(cfg: SimConfig) -> LDPCCode:
    """CodeConfig -> LDPCCode across all supported families."""
    c = cfg.code
    if c.family == "ieee80211n":
        from ..codes.ieee80211n import make_code
        code = make_code(c.n, c.rate)
    elif c.family == "5gnr":
        from ..codes.nr_bg import make_code as make_nr
        code = make_nr(base_graph=c.base_graph, Z=c.Z, rate=c.rate,
                       k_info=c.k_info)
    elif c.family == "dvbs2":
        from ..codes.dvbs2 import make_code as make_dvb
        code = make_dvb(n=c.n, rate=c.rate)
    elif c.family == "toy":
        from ..codes.toy import toy_qc
        code = toy_qc(c.Z or 4)
    elif c.family == "alist":
        if not c.path:
            raise ValueError("alist family requires CodeConfig.path")
        from ..codes.alist import read_alist
        code = read_alist(c.path)
    elif c.family == "qcpeg":
        from ..codes.peg import parse_profile, qc_peg_construct
        if not c.Z:
            raise ValueError("qcpeg family requires CodeConfig.Z")
        if c.n % c.Z:
            raise ValueError(f"qcpeg: n={c.n} not a multiple of Z={c.Z}")
        nb = c.n // c.Z
        kb = round(nb * _rate_value(c.rate))
        if not 0 < kb < nb:
            raise ValueError(f"qcpeg: rate {c.rate} gives kb={kb} of nb={nb}")
        code = qc_peg_construct(kb=kb, cb=nb - kb, Z=c.Z,
                                col_degrees=parse_profile(c.profile, kb),
                                seed=c.code_seed)
    elif c.family == "pbrl":
        from ..codes.peg import parse_profile, pbrl_construct
        if not c.Z:
            raise ValueError("pbrl family requires CodeConfig.Z")
        if c.n % c.Z:
            raise ValueError(f"pbrl: n={c.n} not a multiple of Z={c.Z}")
        nb = c.n // c.Z
        kb = round(nb * _rate_value(c.rate))
        n_ext = nb - kb - c.core_rows
        if not 0 < kb < nb or n_ext < 0:
            raise ValueError(f"pbrl: rate {c.rate} with core_rows="
                             f"{c.core_rows} gives kb={kb}, n_ext={n_ext}")
        code = pbrl_construct(kb=kb, cb=c.core_rows, Z=c.Z, n_ext=n_ext,
                              core_col_degrees=parse_profile(
                                  c.profile, kb) if c.profile
                              else min(3, c.core_rows),
                              ext_row_degree=c.ext_row_degree,
                              seed=c.code_seed)
    else:
        raise ValueError(f"unknown code family {c.family}")
    if c.shorten_bits:
        from ..codes.rate_compat import shorten
        code = shorten(code, c.shorten_bits)
    if c.punct_frac:
        # Generic rate-compatible puncturing on top of ANY family (the NR
        # builder's standard rate matching already lives in punct_vns; the
        # generic order excludes those positions, so the two compose).
        from ..codes.rate_compat import puncture
        code = puncture(code, frac=c.punct_frac, scheme=c.punct_scheme,
                        seed=cfg.run.seed)
    return code


class Sweep:
    """Drives the full BER/FER sweep for one SimConfig.

    mesh: optional jax.sharding.Mesh — the codeword batch is sharded over it.
    checkpoint_path: JSON state written after every superbatch; pass the same
    path again to resume.
    """

    def __init__(self, cfg: SimConfig, mesh=None, decoder_backend: str = "auto",
                 batch: Optional[int] = None,
                 checkpoint_path: Optional[str] = None,
                 lookahead: int = 4, superbatches: int = 1,
                 code: Optional[LDPCCode] = None):
        self.lookahead = max(1, lookahead)
        self.superbatches = max(1, superbatches)
        self._fused_rb = {}  # n_points -> compiled fused run_batch
        self.cfg = cfg
        self.mesh = mesh
        # code: explicit LDPCCode override (constructed/optimized/imported
        # codes not derivable from CodeConfig — e.g. codes/peg.as_optimize
        # output). The checkpoint meta carries code.name, so a resume with
        # a different code refuses (the config check alone can't see it).
        self.code = code if code is not None else build_code(cfg)
        self.batch = batch or cfg.run.batch
        self.checkpoint_path = checkpoint_path
        # phase1_iters == -1: AUTO two-phase ET (sim/tune.py) — the base
        # run_batch is single-phase; run() probes the convergence CDF per
        # SNR point and swaps in a tuned (p1, cap) build when it pays.
        self._auto_phase = (cfg.decoder.phase1_iters == -1
                            and cfg.decoder.early_term)
        self._tuned_rb: Dict = {}
        self._probe = None
        self.run_batch = make_run_batch(
            self.code, cfg, batch=self.batch, mesh=mesh,
            decoder_backend=decoder_backend, superbatches=self.superbatches)
        # Resolved label (rides the jitted callable): pinned so the fused
        # builds below resolve to the SAME backend, and recorded in results.
        self.backend = self.run_batch.backend_label

    def _key(self, snr_idx: int, batch_idx: int) -> jax.Array:
        k = jax.random.PRNGKey(self.cfg.run.seed)
        k = jax.random.fold_in(k, snr_idx)
        return jax.random.fold_in(k, batch_idx)

    def _tuned_run_batch(self, snr_idx: int, sigma: float):
        """AUTO two-phase ET (phase1_iters == -1): probe this point's
        convergence CDF once, pick (p1, cap) with sim/tune.pick_two_phase,
        and return a cached run_batch built with it — or the single-phase
        base when two-phase is not predicted to pay. Counters are
        UNCHANGED either way (two-phase restarts are bit-exact replays);
        only wall time moves, so checkpoints/results need no tuning meta."""
        import dataclasses

        from .tune import make_iter_probe, pick_two_phase
        if self.backend == "jnp-float":
            # float decoders return before the two-phase wrapper in
            # select_decoder — a probe could never change the build
            return self.run_batch
        if self._probe is None:
            self._probe_batch = min(self.batch, 2048)
            self._probe = make_iter_probe(
                self.code, self.cfg, decoder_backend=self.backend,
                batch=self._probe_batch)
        it = np.asarray(self._probe(
            jax.random.fold_in(self._key(snr_idx, 0), 2 ** 31 - 2),
            np.float32(sigma)))
        # capacity floor: phase-2 shapes round up to the resolved decoder
        # tile in select_decoder, and a phase-2 batch of fewer than 128
        # lanes is not worth a second dispatch
        g = max(128, self.run_batch.batch_tile)
        p1, frac = pick_two_phase(it, self.cfg.decoder.max_iter,
                                  tile_frac=min(1.0, g / self.batch))
        log.info("auto two-phase @snr[%d]: unconv@%s -> p1=%s cap=%s",
                 snr_idx, {t: round(float(np.mean(it > t)), 3)
                           for t in (2, 4, 6, 8)}, p1, frac)
        if p1 is None:
            return self.run_batch
        key = (p1, round(frac, 4))
        if key not in self._tuned_rb:
            cfgv = dataclasses.replace(
                self.cfg, decoder=dataclasses.replace(
                    self.cfg.decoder, phase1_iters=p1, phase2_frac=frac))
            self._tuned_rb[key] = make_run_batch(
                self.code, cfgv, batch=self.batch, mesh=self.mesh,
                decoder_backend=self.backend,
                superbatches=self.superbatches)
        return self._tuned_rb[key]

    def _resume(self, meta, points):
        """Shared checkpoint load + validation for run()/run_fused().

        Refuses to merge counters unless BOTH the run meta (batch/
        superbatches/seed/point list — the RNG-stream contract) and the full
        SimConfig match what the checkpoint was written with. Returns
        (points-with-saved-counters, raw state or None)."""
        state = ckpt.load(self.checkpoint_path)
        if state is None:
            return points, None
        core = {k: v for k, v in state.get("meta", {}).items()
                if k != "fused_batch_idx"}
        if core and "code_name" not in core and "code_name" in meta:
            # schema growth: checkpoints written before code_name existed
            # are valid iff everything else matches (the config check
            # below still pins the code family/params)
            meta = {k: v for k, v in meta.items() if k != "code_name"}
        if core and core != meta:
            raise ValueError(
                f"checkpoint {self.checkpoint_path} was written with "
                f"{core}, resume requires the same batch/superbatches/"
                f"seed/point list (got {meta}) for sample-exact "
                f"continuation")
        if state.get("config") and not _config_compatible(state["config"],
                                                          self.cfg):
            raise ValueError(
                f"checkpoint {self.checkpoint_path} was written for a "
                f"different SimConfig; resuming would merge counters from "
                f"a different simulation. Stored: {state['config']}")
        saved = {p.ebn0_db: p for p in state["points"]}
        points = [saved.get(p.ebn0_db, p) for p in points]
        return points, state

    def run_fused(self, ebn0_list: Sequence[float],
                  target_frame_errors: Optional[int] = None,
                  max_frames: Optional[int] = None) -> SweepResult:
        """Fused-SNR sweep: every batch advances MANY points in one device
        program (lanes striped over sigma slots; SURVEY.md §2.3 'sweep
        parallelism').

        Round-2 completion of the mode (VERDICT items): per-point lane
        RETIREMENT — once a point hits its frame-error target, its sigma
        slots are reassigned to still-active points (the compiled program
        takes the sigma vector as data, so reassignment costs nothing);
        lookahead dispatch pipelining; and checkpoint/resume. Counter
        attribution is by the slot->point map recorded at dispatch, so
        accounting stays exact. Resume is deterministic-from-state (the
        slot assignment is recomputed from the saved counters) rather than
        sample-exact in the strict run() sense — noise samples are keyed by
        the global batch index, never reused."""
        from collections import deque
        rc = self.cfg.run
        target_fe = (rc.target_frame_errors if target_frame_errors is None
                     else target_frame_errors)
        max_fr = rc.max_frames if max_frames is None else max_frames
        P = len(ebn0_list)
        if P not in self._fused_rb:
            # cache per point-count: rebuilding would re-jit and re-compile
            # the fused program every call
            self._fused_rb[P] = make_run_batch(
                self.code, self.cfg, batch=self.batch, mesh=self.mesh,
                decoder_backend=self.backend,
                n_points=P, superbatches=self.superbatches)
        rb = self._fused_rb[P]
        base_sigmas = np.asarray(
            [sigma_for(e, self.code.rate, self.cfg.channel.modulation)
             for e in ebn0_list], np.float32)
        points = [SnrPoint(ebn0_db=float(e)) for e in ebn0_list]
        meta = {"batch": self.batch, "superbatches": self.superbatches,
                "seed": self.cfg.run.seed, "code_name": self.code.name,
                "fused_points": [float(e) for e in ebn0_list]}
        batch_idx = 0
        if self.checkpoint_path:
            points, state = self._resume(meta, points)
            if state is not None:
                batch_idx = int(state["meta"].get("fused_batch_idx", 0))
                log.info("resumed fused checkpoint %s at batch %d",
                         self.checkpoint_path, batch_idx)
        result = SweepResult(config=self.cfg, code_name=self.code.name,
                             k=self.code.k_eff, n=self.code.n,
                             points=points, decoder_backend=self.backend)
        frames_per_slot = (self.batch // P) * self.superbatches
        pending = [0] * P  # frames issued but not yet consumed, per point
        inflight: deque = deque()

        def active_points():
            return [i for i, p in enumerate(points)
                    if p.frame_errs < target_fe
                    and p.frames + pending[i] < max_fr]

        t_last = time.time()
        while active_points() or inflight:
            while len(inflight) < self.lookahead:
                act = active_points()
                if not act:
                    break
                slot_map = [act[s % len(act)] for s in range(P)]
                sig = base_sigmas[slot_map]
                fut = rb(self._key(0, batch_idx), sig)
                for i in slot_map:
                    pending[i] += frames_per_slot
                inflight.append((slot_map, fut))
                batch_idx += 1
            if not inflight:
                break
            slot_map, fut = inflight.popleft()
            out = np.asarray(fut)
            now = time.time()
            wall = now - t_last
            t_last = now
            frames, bit_e, frame_e, it_s, conv = out
            touched = sorted(set(slot_map))
            for s in range(P):
                i = slot_map[s]
                p = points[i]
                pending[i] -= frames_per_slot
                p.frames += int(frames[s])
                p.bit_errs += int(bit_e[s])
                p.frame_errs += int(frame_e[s])
                p.iter_sum += int(it_s[s])
                p.converged += int(conv[s])
            for i in touched:
                points[i].wall_s += wall / len(touched)
                points[i].batches += 1
            if self.checkpoint_path:
                # batch_idx already counts dispatched-but-unconsumed batches;
                # persist the CONSUMED horizon so resume re-runs in-flight work.
                ckpt.save(self.checkpoint_path, self.cfg.to_json(), points,
                          meta={**meta,
                                "fused_batch_idx": batch_idx - len(inflight)})
        return result

    def run(self, ebn0_list: Sequence[float],
            target_frame_errors: Optional[int] = None,
            max_frames: Optional[int] = None) -> SweepResult:
        rc = self.cfg.run
        target_fe = (rc.target_frame_errors if target_frame_errors is None
                     else target_frame_errors)
        max_fr = rc.max_frames if max_frames is None else max_frames

        points = [SnrPoint(ebn0_db=float(e)) for e in ebn0_list]
        # The point LIST (values and order) is part of the RNG contract:
        # keys are fold_in(seed, positional snr index), so resuming with a
        # reordered/subset list would silently switch each point onto
        # another point's key stream (round-2 review finding).
        meta = {"batch": self.batch, "superbatches": self.superbatches,
                "seed": self.cfg.run.seed, "code_name": self.code.name,
                "points": [float(e) for e in ebn0_list]}
        if self.checkpoint_path:
            points, state = self._resume(meta, points)
            if state is not None:
                log.info("resumed checkpoint %s", self.checkpoint_path)

        result = SweepResult(config=self.cfg, code_name=self.code.name,
                             k=self.code.k_eff, n=self.code.n,
                             points=points, decoder_backend=self.backend)
        from collections import deque
        frames_per_call = self.batch * self.superbatches
        for si, pt in enumerate(points):
            sigma = sigma_for(pt.ebn0_db, self.code.rate,
                              self.cfg.channel.modulation)
            run_batch = (self._tuned_run_batch(si, sigma)
                         if self._auto_phase else self.run_batch)

            # Pipelined dispatch: keep up to `lookahead` device calls in
            # flight (JAX dispatch is async; only the np.asarray consume
            # blocks). Back-to-back synchronous calls would leave the device
            # idle while the host fetches counters and dispatches the next
            # call; overlap hides that gap. Batches are consumed strictly in key order,
            # so counters and checkpoints stay sample-exact; over-issued
            # batches past the stop condition are consumed too (their frames
            # are valid samples, the key space stays contiguous).
            inflight: deque = deque()
            issued = pt.batches
            frames_issued = pt.frames

            def need_more() -> bool:
                return pt.frame_errs < target_fe and pt.frames < max_fr

            t_last = time.time()
            while need_more() or inflight:
                while (need_more() and len(inflight) < self.lookahead
                       and frames_issued < max_fr):
                    inflight.append(run_batch(self._key(si, issued),
                                              np.float32(sigma)))
                    issued += 1
                    frames_issued += frames_per_call
                out = np.asarray(inflight.popleft())  # blocks on device
                frames, bit_e, frame_e, it_s, conv = map(int, out)
                now = time.time()
                pt.wall_s += now - t_last
                t_last = now
                pt.frames += frames
                pt.bit_errs += bit_e
                pt.frame_errs += frame_e
                pt.iter_sum += it_s
                pt.converged += conv
                pt.batches += 1
                if self.checkpoint_path:
                    ckpt.save(self.checkpoint_path, self.cfg.to_json(),
                              points, meta=meta)
            log.info("EbN0=%.2f dB: frames=%d BER=%.3e FER=%.3e avg_it=%.2f",
                     pt.ebn0_db, pt.frames,
                     pt.bit_errs / max(pt.frames * self.code.k_eff, 1),
                     pt.fer, pt.avg_iters)
        return result
