"""Sweep driver, sharding, determinism, and checkpoint tests
(SURVEY.md §4.2 'Distributed' + 'Integration').

Runs on the 8-fake-device CPU mesh from conftest — the same program that runs
on a multi-card mesh (the fake backend IS the multi-device test double)."""
import json
import os

import jax
import numpy as np
import pytest

from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                             QuantConfig, RunConfig, SimConfig)
from ldpc_tpu.parallel import make_mesh
from ldpc_tpu.sim import Sweep, build_code, make_run_batch
from ldpc_tpu.sim.stats import rates_compatible, wilson_interval


def _toy_cfg(batch=64, **dec):
    return SimConfig(
        code=CodeConfig(family="toy", Z=8),
        channel=ChannelConfig(modulation="bpsk"),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=DecoderConfig(algorithm="min-sum", schedule="flooding",
                              max_iter=8, early_term=True, **dec),
        run=RunConfig(batch=batch, seed=3, target_frame_errors=30,
                      max_frames=400),
    )


def test_run_batch_counters():
    cfg = _toy_cfg()
    code = build_code(cfg)
    rb = make_run_batch(code, cfg, decoder_backend="jnp")
    key = jax.random.PRNGKey(0)
    out = rb(key, np.float32(0.8))
    frames, bit_e, frame_e, it_s, conv = map(int, out)
    assert frames == 64
    assert 0 <= bit_e <= frames * code.k
    assert 0 <= frame_e <= frames
    assert conv + frame_e >= 0  # sanity; converged lanes may still be wrong


def test_mesh_size_invariance():
    """Same seed on 1-device and 8-device meshes -> identical counters
    (partitionable threefry + batch sharding; SURVEY.md §4.2)."""
    cfg = _toy_cfg(batch=64)
    code = build_code(cfg)
    key = jax.random.PRNGKey(9)
    sigma = np.float32(0.9)

    out1 = tuple(map(int, make_run_batch(code, cfg, decoder_backend="jnp")(
        key, sigma)))
    mesh = make_mesh()  # all 8 fake devices
    assert mesh.size == 8
    out8 = tuple(map(int, make_run_batch(code, cfg, mesh=mesh,
                                         decoder_backend="jnp")(key, sigma)))
    assert out1 == out8


def test_fused_mesh_size_invariance():
    """The fused multi-SNR program (per-lane sigma striping + per-point
    segment_sum) must also produce identical counters on 1-device and
    8-device meshes — the point striping is lane-position-dependent, so
    this pins that batch sharding doesn't permute lane->point attribution."""
    import jax.numpy as jnp
    cfg = _toy_cfg(batch=64)
    code = build_code(cfg)
    key = jax.random.PRNGKey(9)
    sigmas = jnp.asarray([0.7, 1.1], jnp.float32)
    out1 = np.asarray(make_run_batch(code, cfg, decoder_backend="jnp",
                                     n_points=2)(key, sigmas))
    mesh = make_mesh()
    out8 = np.asarray(make_run_batch(code, cfg, mesh=mesh, n_points=2,
                                     decoder_backend="jnp")(key, sigmas))
    np.testing.assert_array_equal(out1, out8)


def test_sweep_and_checkpoint_resume(tmp_path):
    """Interrupted + resumed sweep == uninterrupted sweep, sample-exactly."""
    cfg = _toy_cfg(batch=32)
    ebn0 = [2.0]

    full = Sweep(cfg, decoder_backend="jnp").run(ebn0)

    path = str(tmp_path / "state.json")
    s1 = Sweep(cfg, decoder_backend="jnp", checkpoint_path=path)
    # interrupt after exactly 2 superbatches by shrinking the frame budget
    s1.run(ebn0, max_frames=64)
    assert os.path.exists(path)
    s2 = Sweep(cfg, decoder_backend="jnp", checkpoint_path=path)
    resumed = s2.run(ebn0)

    a, b = full.points[0], resumed.points[0]
    assert (a.frames, a.bit_errs, a.frame_errs, a.iter_sum) == \
        (b.frames, b.bit_errs, b.frame_errs, b.iter_sum)


def test_sweep_result_report(tmp_path):
    cfg = _toy_cfg(batch=32)
    res = Sweep(cfg, decoder_backend="jnp").run([1.0, 3.0],
                                                target_frame_errors=10,
                                                max_frames=64)
    rows = res.rows()
    assert len(rows) == 2
    assert rows[0]["fer"] >= rows[1]["fer"] or rows[1]["frames"] > 0
    j = json.loads(res.to_json())
    assert j["results"][0]["frames"] > 0
    from ldpc_tpu.sim.report import to_csv, write_outputs
    csv_text = to_csv(res)
    assert "ebn0_db" in csv_text.splitlines()[0]
    paths = write_outputs(res, str(tmp_path / "out"))
    assert all(os.path.exists(p) for p in paths)


def test_avg_iters_decreases_with_snr():
    """Early-termination property (SURVEY.md §4.2 'Integration: early term')."""
    cfg = _toy_cfg(batch=128)
    res = Sweep(cfg, decoder_backend="jnp").run(
        [0.0, 5.0], target_frame_errors=10 ** 9, max_frames=256)
    lo, hi = res.points
    assert hi.avg_iters < lo.avg_iters


def test_wilson():
    lo, hi = wilson_interval(10, 1000)
    assert lo < 0.01 < hi
    assert rates_compatible(10, 1000, 14, 1000)
    assert not rates_compatible(10, 1000, 400, 1000)


def test_fused_snr_sweep():
    """Fused mode (SURVEY.md §2.3 sweep parallelism): all points advance in
    one device program; rates agree with the sequential driver within
    Monte-Carlo error."""
    from ldpc_tpu.sim.stats import rates_compatible
    cfg = _toy_cfg(batch=64)
    s = Sweep(cfg, decoder_backend="jnp")
    fused = s.run_fused([1.0, 3.0], target_frame_errors=25, max_frames=400)
    seq = s.run([1.0, 3.0], target_frame_errors=25, max_frames=400)
    for pf, ps in zip(fused.points, seq.points):
        assert pf.frames > 0
        assert rates_compatible(pf.frame_errs, pf.frames,
                                ps.frame_errs, ps.frames)


def test_multihost_qam_chain_preset():
    """BASELINE.json:11 capability: the full 16-QAM chain preset (n=1944
    r=3/4 OMS layered) runs end-to-end on the 8-device mesh with sane
    counters."""
    import dataclasses
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import build_code, make_run_batch
    from ldpc_tpu.parallel import make_mesh
    from ldpc_tpu.ops.channel import sigma_for
    cfg = PRESETS["multihost-qam-chain"]
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, batch=64))
    code = build_code(cfg)
    mesh = make_mesh(shape=(2, 4), axes=("host", "device"))
    rb = make_run_batch(code, cfg, batch=64, mesh=mesh, decoder_backend="jnp")
    sigma = np.float32(sigma_for(8.0, code.rate, "16qam"))
    out = np.asarray(rb(jax.random.PRNGKey(0), sigma))
    frames, bit_e, frame_e, it_s, conv = map(int, out)
    assert frames == 64
    assert frame_e < 64  # high SNR: most frames decode
    assert conv > 0


def test_all_zeros_mode():
    """The reference's all-zeros-codeword shortcut: same channel statistics,
    no encoder in the pipeline."""
    import dataclasses
    cfg = _toy_cfg(batch=64)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                           all_zeros=True))
    code = build_code(cfg)
    rb = make_run_batch(code, cfg, decoder_backend="jnp")
    out = np.asarray(rb(jax.random.PRNGKey(1), np.float32(0.8)))
    frames, bit_e, frame_e, _, _ = map(int, out)
    assert frames == 64 and 0 <= frame_e <= 64
    # rates statistically consistent with the random-codeword pipeline
    cfg2 = _toy_cfg(batch=64)
    out2 = np.asarray(make_run_batch(build_code(cfg2), cfg2,
                                     decoder_backend="jnp")(
        jax.random.PRNGKey(1), np.float32(0.8)))
    from ldpc_tpu.sim.stats import rates_compatible
    assert rates_compatible(frame_e, 64, int(out2[2]), 64)


def test_checkpoint_meta_mismatch_rejected(tmp_path):
    """Resuming with different batch/superbatches must fail loudly —
    sample-exactness would silently break otherwise."""
    cfg = _toy_cfg(batch=32)
    path = str(tmp_path / "s.json")
    Sweep(cfg, decoder_backend="jnp", checkpoint_path=path).run(
        [2.0], max_frames=32)
    with pytest.raises(ValueError, match="sample-exact"):
        Sweep(cfg, decoder_backend="jnp", checkpoint_path=path,
              batch=64).run([2.0], max_frames=64)


def test_checkpoint_config_mismatch_rejected(tmp_path):
    """Resuming a checkpoint written for a DIFFERENT SimConfig (code/decoder/
    channel/quant) must fail loudly — merging counters across simulations
    would silently corrupt BER/FER statistics."""
    import dataclasses
    cfg = _toy_cfg(batch=32)
    path = str(tmp_path / "s.json")
    Sweep(cfg, decoder_backend="jnp", checkpoint_path=path).run(
        [2.0], max_frames=32)
    cfg2 = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, max_iter=7))
    with pytest.raises(ValueError, match="different SimConfig"):
        Sweep(cfg2, decoder_backend="jnp", checkpoint_path=path).run(
            [2.0], max_frames=64)


@pytest.mark.parametrize("rng_value,loads", [("host", True),
                                              ("device", False)])
def test_retired_rng_field(rng_value, loads):
    """RunConfig.rng is gone; the host threefry chain it selected by default
    is the only one. Stored configs (results, checkpoints) that carry
    rng='host' still load and still match for resume; 'device' described
    another random family and is refused."""
    import json
    from ldpc_tpu.config import PRESETS, SimConfig
    from ldpc_tpu.sim.sweep import _config_compatible
    cfg = PRESETS["wifi-648-r12-minsum"]
    d = json.loads(cfg.to_json())
    d["run"]["rng"] = rng_value
    assert _config_compatible(d, cfg) is loads
    if loads:
        assert SimConfig.from_json(json.dumps(d)) == cfg
    else:
        with pytest.raises(ValueError, match="no longer supported"):
            SimConfig.from_json(json.dumps(d))



def test_checkpoint_schema_growth_resumes(tmp_path):
    """A checkpoint written BEFORE a config field existed must still resume
    when the new field sits at its dataclass default (the old code behaved
    identically there) — and must refuse at any other value. Regression: the
    round-1 .state artifacts broke every rerun after fields were added."""
    import dataclasses
    import json
    cfg = _toy_cfg(batch=32)
    path = str(tmp_path / "s.json")
    Sweep(cfg, decoder_backend="jnp", checkpoint_path=path).run(
        [2.0], max_frames=32)
    # simulate an old-schema checkpoint: drop a defaulted quant field
    # (phase1_iters/phase2_frac are TUNING-exempt since round 3 — counter-
    # invariant — so the off-default refusal is pinned on alpha_shift,
    # which genuinely changes the simulated decoder)
    state = json.load(open(path))
    assert state["config"]["quant"].pop("alpha_shift") == 2  # default
    json.dump(state, open(path, "w"))
    res = Sweep(cfg, decoder_backend="jnp", checkpoint_path=path).run(
        [2.0], max_frames=64)
    assert res.points[0].frames == 64  # resumed and advanced
    # same dropped field, but the CURRENT config sets it off-default
    json.dump(state, open(path, "w"))
    cfg2 = dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, alpha_shift=3))
    with pytest.raises(ValueError, match="different SimConfig"):
        Sweep(cfg2, decoder_backend="jnp", checkpoint_path=path).run(
            [2.0], max_frames=96)


def test_resume_allows_extended_stop_rules(tmp_path):
    """Stop rules are not part of the simulation identity: extending a
    finished sweep with a larger --max-frames (the canonical resume use
    case) must resume and advance, and the extended counters must equal an
    uninterrupted run of the same total budget (sample-exactness)."""
    import dataclasses
    cfg = _toy_cfg(batch=32)
    path = str(tmp_path / "s.json")
    Sweep(cfg, decoder_backend="jnp", checkpoint_path=path).run(
        [2.0], max_frames=32, target_frame_errors=10 ** 9)
    cfg2 = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, max_frames=96,
                                     target_frame_errors=123))
    res = Sweep(cfg2, decoder_backend="jnp", checkpoint_path=path).run(
        [2.0], max_frames=96, target_frame_errors=10 ** 9)
    assert res.points[0].frames == 96
    ref = Sweep(cfg, decoder_backend="jnp").run(
        [2.0], max_frames=96, target_frame_errors=10 ** 9)
    assert res.points[0].bit_errs == ref.points[0].bit_errs
    assert res.points[0].frame_errs == ref.points[0].frame_errs


def test_run_lookahead_pipelining_exact(tmp_path):
    """Pipelined dispatch (lookahead > 1) must produce identical counters to
    the synchronous path — batches are consumed in key order either way."""
    cfg = _toy_cfg(batch=32)
    r1 = Sweep(cfg, decoder_backend="jnp", lookahead=1).run(
        [2.0], max_frames=128, target_frame_errors=3)
    r4 = Sweep(cfg, decoder_backend="jnp", lookahead=4).run(
        [2.0], max_frames=128, target_frame_errors=3)
    p1, p4 = r1.points[0], r4.points[0]
    # lookahead may legitimately consume MORE batches (over-issue); the
    # prefix it shares with the sync run is identical, so counters per
    # frame agree on the common prefix: compare the sync-run-length prefix
    # by re-running lookahead with the sync run's exact frame budget.
    r4b = Sweep(cfg, decoder_backend="jnp", lookahead=4).run(
        [2.0], max_frames=p1.frames, target_frame_errors=10**9)
    p4b = r4b.points[0]
    assert (p4b.frames, p4b.bit_errs, p4b.frame_errs) == (
        p1.frames, p1.bit_errs, p1.frame_errs)
    assert p4.frames >= p1.frames


def test_fused_retirement_and_checkpoint(tmp_path):
    """Round-2 fused mode: (a) lanes of finished points are reassigned to
    active ones (a much-harder point keeps advancing with MORE than its
    striped share once easy points retire); (b) checkpoint + resume
    continues to completion with consistent totals."""
    cfg = _toy_cfg(batch=64)
    s = Sweep(cfg, decoder_backend="jnp", lookahead=2)
    # Point at 6 dB converges almost always (few frame errors); point at
    # -2 dB almost never. Easy point retires early; hard one inherits lanes.
    fused = s.run_fused([6.0, -2.0], target_frame_errors=8, max_frames=2000)
    clean, noisy = fused.points
    # the noisy point errors on ~every frame -> hits its target in the first
    # batch and RETIRES; the clean point almost never errors -> runs to its
    # frame budget, inheriting the retired point's lanes along the way
    assert noisy.frame_errs >= 8
    assert clean.frames >= 2000
    assert clean.frames > noisy.frames

    # checkpoint path: interrupt by frame budget, then resume to completion
    path = str(tmp_path / "fused.json")
    s1 = Sweep(cfg, decoder_backend="jnp", checkpoint_path=path, lookahead=1)
    r1 = s1.run_fused([6.0, -2.0], target_frame_errors=50, max_frames=128)
    assert os.path.exists(path)
    mid_frames = [p.frames for p in r1.points]
    s2 = Sweep(cfg, decoder_backend="jnp", checkpoint_path=path, lookahead=1)
    r2 = s2.run_fused([6.0, -2.0], target_frame_errors=50, max_frames=512)
    for pm, p2 in zip(mid_frames, r2.points):
        assert p2.frames >= pm  # resumed, not restarted
    # resumed totals are sane: bit errors never exceed total bits
    for p in r2.points:
        assert 0 <= p.bit_errs <= p.frames * build_code(cfg).k

    # wrong point set must be rejected
    with pytest.raises(ValueError, match="resume requires the same"):
        Sweep(cfg, decoder_backend="jnp", checkpoint_path=path).run_fused(
            [6.0, -1.0], target_frame_errors=50, max_frames=256)


def test_snr_at_ber_zero_tail_brackets():
    """Round-2 review finding: a waterfall falling to ZERO measured errors
    at the last sweep point must still bracket the crossing."""
    from ldpc_tpu.sim.stats import snr_at_ber

    rows = [{"ebn0_db": 2.0, "ber": 1e-4, "frames": 10 ** 6},
            {"ebn0_db": 2.5, "ber": 0.0, "frames": 10 ** 6}]
    x = snr_at_ber(rows, 1e-6, k=324)   # floor = 0.5/3.24e8 ~ 1.5e-9
    assert x is not None and 2.0 < x <= 2.5
    # without k: one-decade-below-target sentinel still brackets
    x2 = snr_at_ber(rows, 1e-6)
    assert x2 is not None and 2.0 < x2 <= 2.5
    # insufficient frames cannot resolve the target -> no claimed crossing
    rows_small = [{"ebn0_db": 2.0, "ber": 1e-4, "frames": 100},
                  {"ebn0_db": 2.5, "ber": 0.0, "frames": 100}]
    assert snr_at_ber(rows_small, 1e-6, k=324) is None


def test_resume_rejects_changed_point_list(tmp_path):
    """RNG keys are fold_in(seed, positional snr index): resuming with a
    reordered/subset point list would silently cross key streams — the
    meta guard must refuse (round-2 review finding)."""
    import dataclasses
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import Sweep
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, batch=128, max_frames=128, target_frame_errors=10 ** 9))
    p = str(tmp_path / "ck.json")
    Sweep(cfg, checkpoint_path=p).run([2.0, 2.5])
    with pytest.raises(ValueError, match="point list"):
        Sweep(cfg, checkpoint_path=p).run([2.5])
    # same list resumes fine
    res = Sweep(cfg, checkpoint_path=p).run([2.0, 2.5])
    assert res.rows()[0]["frames"] == 128


def test_checkpoint_resume_accepts_pre_code_name_state(tmp_path):
    """Schema growth: checkpoints written before meta carried code_name
    (round 5, Sweep code= override) must still resume."""
    import json as _json

    cfg = _toy_cfg(batch=32)
    path = str(tmp_path / "state.json")
    s1 = Sweep(cfg, decoder_backend="jnp", checkpoint_path=path)
    s1.run([2.0], max_frames=64)
    st = _json.load(open(path))
    assert st["meta"].pop("code_name", None) is not None
    _json.dump(st, open(path, "w"))
    s2 = Sweep(cfg, decoder_backend="jnp", checkpoint_path=path)
    res = s2.run([2.0], max_frames=128)
    assert res.points[0].frames == 128
