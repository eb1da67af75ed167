"""Auto-tuned two-phase early termination (sim/tune.py). The tuner only
ever changes WALL TIME: two-phase restarts are bit-exact replays, so an
auto-tuned sweep's counters must EQUAL the single-phase sweep's. Whether
it saves wall time on the GPU is not measured yet (ROADMAP.md)."""
import dataclasses

import numpy as np
import pytest

from ldpc_tpu.sim.tune import CAP_QUANTUM, pick_two_phase


class TestPickTwoPhase:
    def test_fast_converging_cdf_picks_small_p1(self):
        rng = np.random.default_rng(0)
        # 97% of lanes converge by iteration 4, stragglers run to 20
        it = np.where(rng.random(4096) < 0.97,
                      rng.integers(2, 5, 4096), 20)
        p1, cap = pick_two_phase(it, max_iter=20, tile_frac=128 / 1024)
        assert p1 is not None and p1 <= 6
        q = float(np.mean(it > p1))
        assert cap >= q  # capacity covers the sampled unconverged fraction
        assert cap <= 0.5
        # snapped to the compile-cache quantum (or the tile floor)
        assert (abs(cap / CAP_QUANTUM - round(cap / CAP_QUANTUM)) < 1e-9
                or cap == 128 / 1024)

    def test_nonconverging_sample_declines(self):
        it = np.full(1024, 20)  # nothing converges early
        p1, cap = pick_two_phase(it, max_iter=20, tile_frac=0.125)
        assert p1 is None and cap is None

    def test_tile_floor_respected(self):
        it = np.full(1024, 2)  # everything converges immediately
        p1, cap = pick_two_phase(it, max_iter=20, tile_frac=0.25)
        assert p1 is not None and cap >= 0.25

    def test_margin_blocks_marginal_wins(self):
        # ~half the lanes straggle: cost(t) ~ t + 20 * 0.5-ish never beats
        # margin * 20
        rng = np.random.default_rng(1)
        it = np.where(rng.random(2048) < 0.5, 3, 20)
        p1, cap = pick_two_phase(it, max_iter=20, tile_frac=0.125)
        assert p1 is None


def _sweep(cfg, ebn0s, **kw):
    from ldpc_tpu.sim import Sweep
    return Sweep(cfg, **kw).run(ebn0s, target_frame_errors=10 ** 9,
                                max_frames=512)


def test_auto_sweep_counters_equal_single_phase():
    """phase1_iters=-1 through a real (CPU jnp) sweep: identical counters
    to the single-phase run — tuning is a pure wall-time decision."""
    from ldpc_tpu.config import PRESETS
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, batch=256),
        decoder=dataclasses.replace(cfg.decoder, max_iter=8,
                                    early_term=True))
    cfg_auto = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, phase1_iters=-1))
    ebn0s = [3.0, 4.0]
    r_plain = _sweep(cfg, ebn0s, batch=256)
    r_auto = _sweep(cfg_auto, ebn0s, batch=256)
    for a, b in zip(r_plain.points, r_auto.points):
        assert (a.frames, a.bit_errs, a.frame_errs, a.iter_sum,
                a.converged) == (b.frames, b.bit_errs, b.frame_errs,
                                 b.iter_sum, b.converged)


@pytest.mark.slow
def test_two_phase_counters_bitexact():
    """Two-phase ET through make_run_batch: both builds draw the same RNG
    stream, so counters must be EQUAL."""
    import jax
    import jax.numpy as jnp
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, batch=256),
        decoder=dataclasses.replace(cfg.decoder, max_iter=6,
                                    early_term=True))
    cfg2 = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, max_iter=6,
                                         early_term=True, phase1_iters=2,
                                         phase2_frac=0.5))
    code = build_code(cfg)
    rb1 = make_run_batch(code, cfg, batch=256, decoder_backend="qc-jnp")
    rb2 = make_run_batch(code, cfg2, batch=256, decoder_backend="qc-jnp")
    assert rb1.backend_label == "qc-jnp"
    assert rb2.backend_label == "qc-jnp-2phase"
    sigma = sigma_for(3.0, code.rate, "bpsk")
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        c1 = np.asarray(rb1(key, jnp.float32(sigma)))
        c2 = np.asarray(rb2(key, jnp.float32(sigma)))
        np.testing.assert_array_equal(c1, c2)


def test_auto_sentinel_is_single_phase_outside_sweep():
    """make_run_batch must treat phase1_iters=-1 as single-phase (no
    negative-iteration decoder)."""
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, batch=256),
        decoder=dataclasses.replace(cfg.decoder, max_iter=4,
                                    early_term=True, phase1_iters=-1))
    code = build_code(cfg)
    rb = make_run_batch(code, cfg, batch=256)
    assert rb.backend_label == "qc-jnp"  # no "-2phase" suffix


def test_auto_declines_for_stream_backend():
    """Where a two-phase rebuild cannot change the decoder (the float
    decoders return before the two-phase wrapper), the tuner must not even
    build a probe."""
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import Sweep
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, batch=256),
        decoder=dataclasses.replace(cfg.decoder, early_term=True,
                                    phase1_iters=-1, max_iter=4,
                                    algorithm="min-sum-float"))
    s = Sweep(cfg, batch=256)
    assert s.backend == "jnp-float"
    rb = s._tuned_run_batch(0, 0.7)
    assert rb is s.run_batch and s._probe is None


def test_checkpoint_resumes_across_tuning_change(tmp_path):
    """Two-phase tuning is counter-invariant, so a checkpoint written
    single-phase must resume under phase1_iters=-1 (review finding: the
    wifi-full-oms preset change would otherwise strand old .state files)."""
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import Sweep
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, batch=128),
        decoder=dataclasses.replace(cfg.decoder, max_iter=4,
                                    early_term=True))
    path = str(tmp_path / "run.state")
    r1 = Sweep(cfg, batch=128, checkpoint_path=path).run(
        [4.0], target_frame_errors=10 ** 9, max_frames=128)
    cfg_auto = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, phase1_iters=-1))
    r2 = Sweep(cfg_auto, batch=128, checkpoint_path=path).run(
        [4.0], target_frame_errors=10 ** 9, max_frames=256)
    assert r2.points[0].frames == 256  # resumed AND extended
    assert r2.points[0].bit_errs >= r1.points[0].bit_errs
