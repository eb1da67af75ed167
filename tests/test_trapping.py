"""Trapping-set analysis + mixture importance sampling
(analysis/trapping.py, sim/impsamp.py).

Oracles: GF(2) syndrome arithmetic for (a, b) classification; brute-force
Gaussian density ratios for the IS weights; plain Monte-Carlo (which the
estimator must degenerate to at K=0 and agree with statistically at K>0 —
mixture IS is unbiased by construction)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ldpc_tpu.analysis.trapping import (
    classify,
    dominant_sets,
    odd_checks,
    refine_support,
    search_trapping_sets,
)
from ldpc_tpu.codes.ieee80211n import make_code as make_wifi
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import CodeConfig, DecoderConfig, SimConfig
from ldpc_tpu.golden import encoder as golden_enc
from ldpc_tpu.sim.impsamp import (
    estimate_fer,
    harvest_error_supports,
    make_is_run,
    mixture_log_weight,
)


@pytest.fixture(scope="module")
def wifi648():
    return make_wifi(648, "1/2")


class TestClassify:
    def test_single_vn(self, wifi648):
        vdeg = len(wifi648.vn_adj()[5])
        assert classify(wifi648, [5]) == (1, vdeg)
        assert len(odd_checks(wifi648, [5])) == vdeg

    def test_codeword_support_is_a0(self, wifi648):
        info = np.random.default_rng(0).integers(0, 2, wifi648.k)
        cw = golden_enc.encode(wifi648, info)
        sup = np.nonzero(cw)[0]
        a, b = classify(wifi648, sup)
        assert a == len(sup) and b == 0

    def test_refine_strips_satellites(self, wifi648):
        info = np.zeros(wifi648.k, np.uint8)
        info[:3] = 1
        cw = golden_enc.encode(wifi648, info)
        sup = set(map(int, np.nonzero(cw)[0]))
        extra = sorted(set(range(wifi648.n)) - sup)[:2]
        refined = refine_support(wifi648, sorted(sup) + extra)
        # satellites (whose removal lowers b) are gone; the codeword core
        # (whose removal would raise b from 0) survives intact
        assert refined == frozenset(sup)


class TestSearch:
    def test_classes_consistent(self):
        code = toy_qc(8)
        found = search_trapping_sets(code, a_max=6, b_max=4, max_sets=64)
        assert found, "search found nothing on the toy code"
        for (a, b), sets in found.items():
            assert a <= 6 and b <= 4
            for s in sets:
                assert classify(code, s) == (a, b)

    def test_seeded_with_harvest_style_support(self, wifi648):
        found = search_trapping_sets(wifi648, a_max=5, b_max=6,
                                     seeds=[[0, 1, 2]], per_vn_seeds=False)
        assert all(classify(wifi648, s) == (a, b)
                   for (a, b), ss in found.items() for s in ss)

    def test_dominant_ranking(self):
        code = toy_qc(8)
        found = search_trapping_sets(code, a_max=6, b_max=6, max_sets=64)
        dom = dominant_sets(found, k=5)
        costs = [sum(classify(code, s)) for s in dom]
        assert costs == sorted(costs)


class TestMixtureWeights:
    def test_against_bruteforce_density_ratio(self):
        rng = np.random.default_rng(0)
        n, K, B = 12, 3, 64
        sigma, delta, pi0 = 0.8, 2.0, 0.4
        M = (rng.random((K, n)) < 0.3).astype(np.float32)
        sizes = M.sum(axis=1).astype(np.float32)
        log_pi = np.log(np.concatenate([[pi0], np.full(K, (1 - pi0) / K)])
                        ).astype(np.float32)
        z = rng.normal(0, sigma, (B, n)).astype(np.float32)
        lw = np.asarray(mixture_log_weight(
            jnp.asarray(z), jnp.asarray(M), jnp.asarray(sizes),
            jnp.asarray(log_pi), delta, sigma))
        # brute force: unnormalized Gaussian densities (normalizers cancel)
        mus = np.concatenate([np.zeros((1, n)), -delta * M], axis=0)
        pis = np.exp(log_pi)
        dens = np.stack([
            np.exp(-((z - mu) ** 2).sum(axis=1) / (2 * sigma ** 2))
            for mu in mus], axis=1)  # (B, K+1)
        ref = np.log(dens[:, 0]) - np.log(dens @ pis)
        np.testing.assert_allclose(lw, ref, rtol=2e-4, atol=2e-4)
        # defensive bound: w <= 1/pi0
        assert (lw <= -np.log(pi0) + 1e-5).all()

    def test_weights_match_float64_at_floor_sizes(self):
        """The z @ M.T product runs at full float32 precision (a GPU may
        otherwise use TF32, ~3 decimal digits): the weights at a floor-study
        size (n=648, large |z.mu| terms) match a float64 NumPy evaluation
        to 1e-5 relative."""
        rng = np.random.default_rng(1)
        n, K, B = 648, 16, 256
        sigma, delta, pi0 = 0.7, 2.5, 0.5
        M = (rng.random((K, n)) < 0.02).astype(np.float32)
        sizes = M.sum(axis=1).astype(np.float32)
        log_pi = np.log(np.concatenate([[pi0], np.full(K, (1 - pi0) / K)])
                        ).astype(np.float32)
        z = rng.normal(0, sigma, (B, n)).astype(np.float32)
        lw = np.asarray(mixture_log_weight(
            jnp.asarray(z), jnp.asarray(M), jnp.asarray(sizes),
            jnp.asarray(log_pi), delta, sigma))
        s_k = z.astype(np.float64) @ M.T.astype(np.float64)
        expo = (-2.0 * delta * s_k - delta ** 2 * sizes) / (2 * sigma ** 2)
        terms = np.concatenate([np.zeros((B, 1)), expo], axis=1) + log_pi
        mx = terms.max(axis=1, keepdims=True)
        ref = -(mx[:, 0] + np.log(np.exp(terms - mx).sum(axis=1)))
        np.testing.assert_allclose(np.exp(lw), np.exp(ref), rtol=1e-5)


def _cfg():
    return SimConfig(code=CodeConfig(),
                     decoder=DecoderConfig(algorithm="offset-min-sum",
                                           max_iter=10))


class TestISEstimator:
    def test_k0_degenerates_to_plain_mc(self, wifi648):
        cfg = _cfg()
        run = make_is_run(wifi648, cfg, sets=[], batch=256, backend="jnp")
        out = np.asarray(run(jax.random.PRNGKey(0), 0.9))
        # with no sets every weight is 1: sum(w*err) == raw error count
        assert out[0] == out[2]
        assert out[1] == out[2]  # (1*err)^2 sums identically

    def test_estimate_matches_plain_mc_statistically(self, wifi648):
        # 2.0 dB: FER ~0.1 — both plain MC and IS resolve it cheaply; the
        # unbiased mixture must land within combined confidence bounds.
        cfg = _cfg()
        frames = 2048
        plain = estimate_fer(wifi648, cfg, sets=[], ebn0_db=2.0,
                             frames=frames, batch=512, backend="jnp",
                             seed=5)
        sets = [[0, 1, 2, 3], [640, 641, 642]]
        mixed = estimate_fer(wifi648, cfg, sets=sets, ebn0_db=2.0,
                             frames=frames, batch=512, backend="jnp",
                             seed=7, delta=2.0, pi0=0.5)
        assert plain.fer > 0 and mixed.fer > 0
        tol = 5 * (plain.fer * plain.rel_std + mixed.fer * mixed.rel_std)
        assert abs(plain.fer - mixed.fer) <= tol

    def test_harvest_returns_classifiable_supports(self, wifi648):
        cfg = _cfg()
        sup = harvest_error_supports(wifi648, cfg, ebn0_db=1.0, frames=512,
                                     batch=256, backend="jnp", seed=2)
        assert sup, "no failures harvested at 1.0 dB?!"
        for s in sup[:4]:
            a, b = classify(wifi648, s)
            assert a == len(s) >= 1

    def test_rejects_non_bpsk(self, wifi648):
        cfg = SimConfig(code=CodeConfig(),
                        channel=__import__("dataclasses").replace(
                            _cfg().channel, modulation="16qam"))
        with pytest.raises(ValueError):
            make_is_run(wifi648, cfg, sets=[], batch=64)


class TestISMesh:
    def test_mesh_counters_match_unsharded(self, wifi648):
        # DP contract for the IS estimator: the partitionable threefry
        # stream makes the SAMPLES identical under sharding; only the f32
        # summation order may differ across shards.
        from ldpc_tpu.parallel.mesh import make_mesh
        cfg = _cfg()
        sets = [[0, 1, 2, 3], [640, 641, 642]]
        key = jax.random.PRNGKey(3)
        run1 = make_is_run(wifi648, cfg, sets=sets, batch=256,
                           backend="jnp")
        run8 = make_is_run(wifi648, cfg, sets=sets, batch=256,
                           backend="jnp", mesh=make_mesh())
        a = np.asarray(run1(key, 0.9), np.float64)
        b = np.asarray(run8(key, 0.9), np.float64)
        np.testing.assert_allclose(a, b, rtol=3e-6)

    def test_mesh_batch_divisibility(self, wifi648):
        from ldpc_tpu.parallel.mesh import make_mesh
        with pytest.raises(ValueError):
            make_is_run(wifi648, _cfg(), sets=[], batch=250,
                        backend="jnp", mesh=make_mesh())


class TestRateMatchedIS:
    """Round-5: the IS chain models rate matching natively, with the
    pipeline's exact contract (punctured -> LLR 0, shortened -> saturated,
    sigma from the EFFECTIVE rate k_eff/n_tx). Oracle: the production
    pipeline itself (Sweep plain MC) plus the unbiasedness anchor."""

    @pytest.fixture(scope="class")
    def pcfg(self):
        import dataclasses
        cfg = _cfg()
        return dataclasses.replace(cfg, code=dataclasses.replace(
            cfg.code, punct_frac=81 / 648))

    @pytest.fixture(scope="class")
    def pcode(self, pcfg):
        from ldpc_tpu.sim.sweep import build_code
        return build_code(pcfg)

    def test_assemble_llr_contract(self, pcode):
        from ldpc_tpu.ops.channel import demap
        from ldpc_tpu.sim.impsamp import _assemble_llr, _rate_match
        tx_pos, short_pos = _rate_match(pcode)
        assert short_pos is None
        assert len(tx_pos) == pcode.n_tx
        assert not set(map(int, tx_pos)) & set(map(int, pcode.punct_vns))
        z = 0.3 * jnp.ones((2, len(tx_pos)), jnp.float32)
        full = np.asarray(_assemble_llr(z, 0.8, pcode, tx_pos, short_pos, 2))
        assert (full[:, np.asarray(pcode.punct_vns)] == 0).all()
        np.testing.assert_allclose(
            full[:, tx_pos], np.asarray(demap(1.0 + z, 0.8, "bpsk")),
            rtol=1e-6)

    def test_k0_matches_pipeline_sweep(self, pcfg, pcode):
        import dataclasses
        from ldpc_tpu.sim.sweep import Sweep
        cfg = dataclasses.replace(pcfg, run=dataclasses.replace(
            pcfg.run, batch=512, all_zeros=True, seed=3))
        res = Sweep(cfg, decoder_backend="jnp").run(
            [2.0], target_frame_errors=10 ** 9, max_frames=3072)
        pt = res.points[0]
        fer_mc = pt.frame_errs / pt.frames
        est = estimate_fer(pcode, pcfg, sets=[], ebn0_db=2.0, frames=3072,
                           batch=512, backend="jnp", seed=11)
        assert est.fer > 0 and fer_mc > 0
        se = np.sqrt(fer_mc * (1 - fer_mc) / pt.frames)
        tol = 5 * (se + est.fer * est.rel_std)
        assert abs(est.fer - fer_mc) <= tol

    def test_mixture_unbiased_on_punctured(self, pcfg, pcode):
        frames = 2048
        plain = estimate_fer(pcode, pcfg, sets=[], ebn0_db=2.0,
                             frames=frames, batch=512, backend="jnp",
                             seed=5)
        # sets straddling transmitted and punctured (tail >= 567)
        # positions: the mean shift must apply only to transmitted members
        sets = [[0, 1, 2, 3], [560, 561, 600, 640]]
        mixed = estimate_fer(pcode, pcfg, sets=sets, ebn0_db=2.0,
                             frames=frames, batch=512, backend="jnp",
                             seed=7)
        assert plain.fer > 0 and mixed.fer > 0
        tol = 5 * (plain.fer * plain.rel_std + mixed.fer * mixed.rel_std)
        assert abs(plain.fer - mixed.fer) <= tol

    def test_fully_punctured_set_dropped(self, pcfg, pcode):
        with pytest.warns(UserWarning, match="dropped"):
            run = make_is_run(pcode, pcfg, sets=[[610, 620, 640]],
                              batch=64, backend="jnp")
        # the proposal collapsed to plain MC: every weight is 1
        out = np.asarray(run(jax.random.PRNGKey(0), 0.8))
        assert out[0] == out[2]

    def test_shortened_harvest_and_estimate(self):
        import dataclasses
        cfg = _cfg()
        cfg = dataclasses.replace(cfg, code=dataclasses.replace(
            cfg.code, shorten_bits=54))
        from ldpc_tpu.sim.sweep import build_code
        code = build_code(cfg)
        assert len(code.shortened_vns) == 54
        sup = harvest_error_supports(code, cfg, ebn0_db=0.8, frames=512,
                                     batch=128, backend="jnp", seed=2)
        assert sup, "no failures harvested at 0.8 dB?!"
        est = estimate_fer(code, cfg, sets=[list(map(int, sup[0]))[:6]],
                           ebn0_db=1.0, frames=512, batch=128,
                           backend="jnp")
        assert np.isfinite(est.fer)


class TestStratifiedIS:
    """Stratified per-component allocation (round 4): deterministic lane
    counts remove the multinomial component-count noise; Neyman allocation
    reweights strata by pilot-measured std. Estimator stays unbiased."""

    def test_apportion(self):
        from ldpc_tpu.sim.impsamp import _apportion
        pis = np.asarray([0.5, 0.25, 0.25])
        c = _apportion(pis, 8)
        assert c.sum() == 8 and (c >= 1).all() and c[0] == 4
        c = _apportion(np.asarray([0.999, 0.0005, 0.0005]), 4)
        assert c.sum() == 4 and (c >= 1).all()
        with pytest.raises(ValueError):
            _apportion(pis, 2)

    def test_stratified_matches_plain_mc(self, wifi648):
        cfg = _cfg()
        frames = 2048
        plain = estimate_fer(wifi648, cfg, sets=[], ebn0_db=2.0,
                             frames=frames, batch=512, backend="jnp",
                             seed=5)
        sets = [[0, 1, 2, 3], [640, 641, 642]]
        strat = estimate_fer(wifi648, cfg, sets=sets, ebn0_db=2.0,
                             frames=frames, batch=512, backend="jnp",
                             seed=9, stratify=True)
        assert strat.frames == frames
        assert plain.fer > 0 and strat.fer > 0
        tol = 5 * (plain.fer * plain.rel_std + strat.fer * strat.rel_std)
        assert abs(plain.fer - strat.fer) <= tol

    def test_stratified_run_shape_and_flags(self, wifi648):
        from ldpc_tpu.sim.impsamp import _apportion
        cfg = _cfg()
        sets = [[0, 1, 2, 3], [5, 6, 7]]
        run = make_is_run(wifi648, cfg, sets=sets, batch=64, backend="jnp",
                          stratify=True)
        assert run.stratified and run.n_comp == 3
        counts = _apportion(run.pis, 64)
        out = np.asarray(run(jax.random.PRNGKey(0), 0.9,
                             jnp.asarray(counts)))
        assert out.shape == (4, 3)
        # raw error count per stratum is bounded by that stratum's lanes
        assert (out[2] <= counts).all()

    def test_neyman_allocation_runs(self, wifi648):
        cfg = _cfg()
        sets = [[0, 1, 2, 3], [640, 641, 642]]
        est = estimate_fer(wifi648, cfg, sets=sets, ebn0_db=2.0,
                           frames=1024, batch=256, backend="jnp",
                           stratify=True, allocation="neyman",
                           pilot_frames=512, seed=3)
        # pilot is excluded: main-phase frames only
        assert est.frames == 1024 and np.isfinite(est.fer) and est.fer > 0

    def test_stratify_with_no_sets_degenerates(self, wifi648):
        cfg = _cfg()
        run = make_is_run(wifi648, cfg, sets=[], batch=64, backend="jnp",
                          stratify=True)
        assert not run.stratified
        out = np.asarray(run(jax.random.PRNGKey(0), 0.9))
        assert out.shape == (4,)

    def test_stratified_mesh_matches_unsharded(self, wifi648):
        from ldpc_tpu.parallel.mesh import make_mesh
        from ldpc_tpu.sim.impsamp import _apportion
        cfg = _cfg()
        sets = [[0, 1, 2, 3], [640, 641, 642]]
        key = jax.random.PRNGKey(3)
        run1 = make_is_run(wifi648, cfg, sets=sets, batch=256,
                           backend="jnp", stratify=True)
        run8 = make_is_run(wifi648, cfg, sets=sets, batch=256,
                           backend="jnp", stratify=True, mesh=make_mesh())
        counts = jnp.asarray(_apportion(run1.pis, 256))
        a = np.asarray(run1(key, 0.9, counts), np.float64)
        b = np.asarray(run8(key, 0.9, counts), np.float64)
        np.testing.assert_allclose(a, b, rtol=3e-6)

    def test_invalid_allocation_rejected(self, wifi648):
        with pytest.raises(ValueError, match="allocation"):
            estimate_fer(wifi648, _cfg(), sets=[[0, 1]], ebn0_db=2.0,
                         frames=64, batch=64, backend="jnp",
                         allocation="optimal")


class TestRateMatchingGuards:
    def test_proto_analyses_reject_partial_blocks(self, wifi648):
        # Bit-granular puncturing (not Z-aligned) cannot be represented in
        # the per-column analyses; they must refuse, not over-puncture.
        from ldpc_tpu.analysis.exit import sigma_ch_columns
        from ldpc_tpu.analysis.proto_de import column_channel_pmfs
        from ldpc_tpu.codes.rate_compat import puncture
        from ldpc_tpu.config import QuantConfig
        p = puncture(wifi648, count=40)  # 40 % 27 != 0 -> partial block
        with pytest.raises(ValueError, match="partially"):
            sigma_ch_columns(p, 0.8)
        with pytest.raises(ValueError, match="partially"):
            column_channel_pmfs(p, 0.8, QuantConfig())
        # Z-aligned puncturing still passes
        ok = puncture(wifi648, count=81)
        assert (sigma_ch_columns(ok, 0.8)[-3:] == 0).all()


class TestPexitBracketGuard:
    def test_saturated_bracket_raises(self):
        import numpy as np
        from ldpc_tpu.analysis.exit import pexit_threshold_sigma
        from ldpc_tpu.codes.toy import toy_qc
        B = toy_qc(8).base
        with pytest.raises(ValueError, match="bracket"):
            pexit_threshold_sigma(np.asarray(B), bracket=(0.1, 0.2),
                                  iters=200)


class TestReviewFixes:
    def test_prebuilt_run_batch_wins(self, wifi648):
        # a prebuilt run sums over ITS batch; estimate_fer must account
        # with that batch, not its own default
        cfg = _cfg()
        run = make_is_run(wifi648, cfg, sets=[], batch=256, backend="jnp")
        est = estimate_fer(wifi648, cfg, sets=[], ebn0_db=1.0, frames=256,
                           batch=64, run=run)
        assert est.frames == 256  # one 256-frame batch, not 4x64

    def test_snr_points_use_independent_streams(self, wifi648):
        cfg = _cfg()
        run = make_is_run(wifi648, cfg, sets=[], batch=256, backend="jnp")
        a = estimate_fer(wifi648, cfg, sets=[], ebn0_db=1.0, frames=256,
                         run=run, seed=3)
        b = estimate_fer(wifi648, cfg, sets=[], ebn0_db=1.001, frames=256,
                         run=run, seed=3)
        # near-identical sigma, different fold -> different raw error counts
        # (with the old shared stream these were bit-identical draws)
        assert (a.raw_hits != b.raw_hits) or (a.fer != b.fer)

    def test_duplicate_set_indices_are_deduped(self):
        import jax.numpy as jnp
        # sizes must describe the APPLIED shift: [5,5,9] shifts {5,9}
        lw_dup = mixture_log_weight(
            jnp.zeros((1, 12)), jnp.asarray(np.eye(12, dtype=np.float32)[
                [5, 9]].sum(axis=0, keepdims=True)),
            jnp.asarray([2.0], jnp.float32),
            jnp.log(jnp.asarray([0.5, 0.5], jnp.float32)), 2.0, 1.0)
        from ldpc_tpu.codes.toy import toy_qc
        code = toy_qc(4)
        cfg = _cfg()
        run = make_is_run(code, cfg, sets=[[5, 5, 9]], batch=128,
                          backend="jnp", pi0=0.5)
        out = np.asarray(run(jax.random.PRNGKey(0), 0.7))
        assert np.isfinite(out).all()

    def test_zero_fer_json_safe(self, wifi648):
        import json
        cfg = _cfg()
        est = estimate_fer(wifi648, cfg, sets=[], ebn0_db=12.0, frames=256,
                           batch=256, backend="jnp")
        assert est.fer == 0.0
        s = json.dumps(est.to_dict())  # must not emit Infinity
        assert "Infinity" not in s
        assert json.loads(s)["rel_std"] is None

    def test_search_respects_a_max_for_seeds(self, wifi648):
        big_seed = list(range(30))  # a=30 > a_max
        found = search_trapping_sets(wifi648, a_max=5, b_max=60,
                                     seeds=[big_seed], per_vn_seeds=False)
        assert all(a <= 5 for (a, b) in found)


class TestISWithTwoPhaseET:
    def test_two_phase_decoder_composes(self, wifi648):
        # phase1_iters triggers the two-phase repacking wrapper inside
        # select_decoder; the IS chain must jit through it unchanged
        import dataclasses as dc
        cfg = _cfg()
        cfg = dc.replace(cfg, decoder=dc.replace(
            cfg.decoder, early_term=True, phase1_iters=4, phase2_frac=0.5))
        run = make_is_run(wifi648, cfg, sets=[[0, 1, 2]], batch=256,
                          backend="jnp")
        out = np.asarray(run(jax.random.PRNGKey(1), 0.85))
        assert np.isfinite(out).all() and out[2] >= 0


class TestAbsorbing:
    def test_codeword_support_is_absorbing(self, wifi648):
        from ldpc_tpu.analysis.trapping import is_absorbing
        info = np.random.default_rng(0).integers(0, 2, wifi648.k)
        cw = golden_enc.encode(wifi648, info)
        # b = 0: every neighbor check satisfied -> absorbing by definition
        assert is_absorbing(wifi648, np.nonzero(cw)[0])

    def test_single_bit_not_absorbing(self, wifi648):
        from ldpc_tpu.analysis.trapping import is_absorbing
        # a lone flipped bit leaves ALL its checks unsatisfied
        assert not is_absorbing(wifi648, [0])

    def test_handcrafted(self):
        from ldpc_tpu.analysis.trapping import is_absorbing
        from ldpc_tpu.codes.code import LDPCCode
        # v0 has checks {c0,c1,c2}; v1 has {c0,c1,c3}. S={v0,v1}:
        # c0,c1 even (2 hits), c2,c3 odd -> each VN: 1 odd of 3 -> absorbing
        cn = [np.array([0, 1], np.int32), np.array([0, 1], np.int32),
              np.array([0, 2], np.int32), np.array([1, 2], np.int32)]
        code = LDPCCode(name="h", n=3, m=4, k=0, cn_adj=cn)
        assert is_absorbing(code, [0, 1])
        assert not is_absorbing(code, [0])


class TestRadialLadder:
    """Per-set shift depths (round 4): the same support at several deltas
    as separate mixture components — the deep-floor variance fix."""

    def test_expand_radial(self):
        from ldpc_tpu.sim.impsamp import expand_radial
        sets, d = expand_radial([[0, 1], [5]], [1.0, 2.0])
        assert sets == [[0, 1], [0, 1], [5], [5]]
        np.testing.assert_allclose(d, [1.0, 2.0, 1.0, 2.0])
        with pytest.raises(ValueError):
            expand_radial([[0]], [])

    def test_vector_delta_matches_scalar(self, wifi648):
        cfg = _cfg()
        sets = [[0, 1, 2, 3], [640, 641, 642]]
        key = jax.random.PRNGKey(5)
        a = make_is_run(wifi648, cfg, sets=sets, batch=128, backend="jnp",
                        delta=2.0)(key, 0.9)
        b = make_is_run(wifi648, cfg, sets=sets, batch=128, backend="jnp",
                        delta=[2.0, 2.0])(key, 0.9)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)

    def test_ladder_unbiased(self, wifi648):
        from ldpc_tpu.sim.impsamp import expand_radial
        cfg = _cfg()
        frames = 2048
        plain = estimate_fer(wifi648, cfg, sets=[], ebn0_db=2.0,
                             frames=frames, batch=512, backend="jnp",
                             seed=5)
        sets, d = expand_radial([[0, 1, 2, 3], [640, 641, 642]],
                                [1.0, 1.5, 2.0])
        lad = estimate_fer(wifi648, cfg, sets=sets, ebn0_db=2.0,
                           frames=frames, batch=512, backend="jnp",
                           seed=13, delta=d, stratify=True)
        assert plain.fer > 0 and lad.fer > 0
        tol = 5 * (plain.fer * plain.rel_std + lad.fer * lad.rel_std)
        assert abs(plain.fer - lad.fer) <= tol

    def test_delta_validation(self, wifi648):
        with pytest.raises(ValueError, match="delta"):
            make_is_run(wifi648, _cfg(), sets=[[0, 1]], batch=64,
                        backend="jnp", delta=[2.0, -1.0])

    def test_ladder_survives_dropped_sets(self):
        # per-set deltas stay aligned when fully-punctured sets drop
        import dataclasses
        cfg = _cfg()
        cfg = dataclasses.replace(cfg, code=dataclasses.replace(
            cfg.code, punct_frac=81 / 648))
        from ldpc_tpu.sim.sweep import build_code
        pcode = build_code(cfg)
        with pytest.warns(UserWarning, match="dropped"):
            run = make_is_run(pcode, cfg, sets=[[610, 620], [0, 1, 2]],
                              delta=[9.0, 2.0], batch=64, backend="jnp")
        out = np.asarray(run(jax.random.PRNGKey(0), 0.8))
        assert out.shape == (4,) and np.isfinite(out).all()


class TestSymmetricIS:
    """Symmetry-folded mixture IS (round 5 — sim/impsamp.py
    make_symmetric_run): one canonical representative per QC orbit,
    exact M0/M multiplicity-corrected Z-fold (unbiased for the total FER
    with no union-bound or support-size gate). Validated against the
    converged wifi-648 deep floor on CPU (5.0 dB vs the ladder
    artifact's 1.10e-12); these tests pin the mechanics."""

    def test_canonical_rotation_invariance(self):
        from ldpc_tpu.sim.impsamp import canonical_rotation
        code = toy_qc(8)
        Z = code.Z
        sup = [3, 2 * Z + 5, 3 * Z + 1]
        canon = canonical_rotation(code, sup)
        for r in range(Z):
            rot = [(v // Z) * Z + (v % Z + r) % Z for v in sup]
            assert canonical_rotation(code, rot) == canon
        # idempotent
        assert canonical_rotation(code, list(canon)) == canon

    def test_run_shape_and_accounting(self):
        from ldpc_tpu.sim.impsamp import make_symmetric_run
        code = toy_qc(8)
        cfg = _cfg()
        reps = [[0, 8], [16]]
        run = make_symmetric_run(code, cfg, reps, delta=1.5, pi0=0.5,
                                 batch=128, backend="jnp")
        out = np.asarray(run(jax.random.PRNGKey(2), 0.9))
        assert out.shape == (4, len(reps) + 2)
        assert np.isfinite(out).all()
        # column K+1 totals the whole batch: >= sum of attributed splits
        K = len(reps)
        assert out[2, K + 1] >= out[2, :K].sum() - 1e-6
        assert abs(out[0, :K + 1].sum() - out[0, K + 1]) < 1e-4

    def test_zfold_consistent_with_plain_is(self):
        """Unbiasedness cross-check on the toy code: symmetric (1 rep per
        orbit, Z-fold) vs plain stratified IS with the FULL orbit
        expansion — both estimate the same FER; agree within errors."""
        from ldpc_tpu.sim.impsamp import (estimate_fer,
                                          estimate_fer_symmetric,
                                          expand_radial)
        code = toy_qc(8)
        Z = code.Z
        cfg = _cfg()
        rep = [0, 8]          # canonical support
        full = [[(v // Z) * Z + (v % Z + r) % Z for v in rep]
                for r in range(Z)]
        frames = 8192
        sym = estimate_fer_symmetric(code, cfg, [rep], ebn0_db=2.0,
                                     frames=frames, delta=1.5, pi0=0.5,
                                     batch=512, backend="jnp", seed=3)
        sets_x, d = expand_radial(full, [1.5])
        plain = estimate_fer(code, cfg, sets=sets_x, ebn0_db=2.0,
                             frames=frames, delta=d, pi0=0.5, batch=512,
                             backend="jnp", seed=4, stratify=True)
        assert sym["fer"] > 0 and plain.fer > 0
        tol = 5 * (sym["fer"] * sym["rel_std"]
                   + plain.fer * plain.rel_std)
        assert abs(sym["fer"] - plain.fer) <= tol

    def test_requires_qc_and_reps(self):
        from ldpc_tpu.codes.code import LDPCCode
        from ldpc_tpu.sim.impsamp import make_symmetric_run
        cn = [np.array([0, 1], np.int32), np.array([1, 2], np.int32)]
        nonqc = LDPCCode(name="nonqc", n=3, m=2, k=1, cn_adj=cn)
        with pytest.raises(ValueError, match="QC"):
            make_symmetric_run(nonqc, _cfg(), [[0]])
        with pytest.raises(ValueError, match="representative"):
            make_symmetric_run(toy_qc(8), _cfg(), [])
