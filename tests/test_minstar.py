"""Fixed-point min* (approx sum-product) decoder family (late round 4).

The classic hardware step between min-sum and sum-product: pairwise
box-plus with a threshold-LUT Jacobian correction
(config.minstar_thresholds), exclude-self via prefix/suffix combines in
pinned neighbor order. Oracles: the golden scalar model (the single
source of truth — the QC-jnp implementation must match it EXACTLY), the
empty-LUT degeneracy to plain min-sum, and plain-MC BER dominance over
min-sum (min* approaches sum-product)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ldpc_tpu.codes.ieee80211n import make_code as make_wifi
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import (CodeConfig, DecoderConfig, QuantConfig,
                             SimConfig, cn_params, minstar_thresholds)
from ldpc_tpu.golden import decoder as gold


class TestThresholds:
    def test_scale4_reference_values(self):
        assert minstar_thresholds(QuantConfig(scale=4.0)) == (8, 3, 0)

    def test_descending_and_scaling(self):
        for scale in (1.0, 2.0, 4.0, 8.0):
            t = minstar_thresholds(QuantConfig(scale=scale))
            assert list(t) == sorted(t, reverse=True)
            assert len(t) == int(np.floor(scale * np.log(2) + 0.5))

    def test_cn_params_rejects_minstar(self):
        with pytest.raises(ValueError, match="minstar_thresholds"):
            cn_params(DecoderConfig(algorithm="min-star"), QuantConfig())


class TestGoldenMinstar:
    def test_empty_lut_degenerates_to_minsum(self):
        code = toy_qc(8)
        rng = np.random.default_rng(0)
        for schedule in ("flooding", "layered"):
            for _ in range(5):
                chan = rng.integers(-40, 41, code.n).astype(np.int32)
                a = gold.decode_fixed(chan, code, max_iter=10,
                                      schedule=schedule, minstar=())
                b = gold.decode_fixed(chan, code, max_iter=10,
                                      schedule=schedule)
                np.testing.assert_array_equal(a.hard, b.hard)
                assert a.iters == b.iters and a.converged == b.converged

    def test_boxplus_matches_float_jacobian(self):
        # the integer correction is the round-to-nearest of the true
        # ln(1+e^-u) term at scale 4 for u in range
        scale = 4.0
        T = minstar_thresholds(QuantConfig(scale=scale))
        for u in range(0, 30):
            c_float = scale * np.log1p(np.exp(-u / scale))
            assert int(gold._corr(u, T)) == int(np.floor(c_float + 0.5))

    def test_rejects_beta_alpha(self):
        code = toy_qc(4)
        with pytest.raises(ValueError, match="compose"):
            gold.decode_fixed(np.zeros(code.n, np.int32), code, beta=2,
                              minstar=(8, 3, 0))


class TestQCEquality:
    @pytest.mark.parametrize("schedule", ["flooding", "layered"])
    def test_qc_jnp_matches_golden(self, schedule):
        from ldpc_tpu.ops.decode_qc import make_qc_decoder
        code = toy_qc(8)
        T = (8, 3, 0)
        dec = make_qc_decoder(code, max_iter=8, schedule=schedule,
                              early_term=True, minstar=T)
        rng = np.random.default_rng(3)
        chan = rng.integers(-30, 31, (16, code.n)).astype(np.int8)
        hard, iters, conv = (np.asarray(x) for x in dec(jnp.asarray(chan)))
        for b in range(16):
            g = gold.decode_fixed(chan[b].astype(np.int32), code,
                                  max_iter=8, schedule=schedule,
                                  minstar=T)
            np.testing.assert_array_equal(hard[b], g.hard,
                                          err_msg=f"lane {b}")
            assert iters[b] == g.iters and bool(conv[b]) == g.converged

    @pytest.mark.slow
    def test_qc_jnp_matches_golden_wifi648(self):
        from ldpc_tpu.ops.decode_qc import make_qc_decoder
        code = make_wifi(648, "1/2")
        T = minstar_thresholds(QuantConfig())
        dec = make_qc_decoder(code, max_iter=6, schedule="layered",
                              early_term=True, minstar=T)
        rng = np.random.default_rng(7)
        chan = rng.integers(-25, 26, (4, code.n)).astype(np.int8)
        hard, iters, conv = (np.asarray(x) for x in dec(jnp.asarray(chan)))
        for b in range(4):
            g = gold.decode_fixed(chan[b].astype(np.int32), code,
                                  max_iter=6, schedule="layered",
                                  minstar=T)
            np.testing.assert_array_equal(hard[b], g.hard)
            assert iters[b] == g.iters


class TestMinstarDE:
    """Round-5 min* density evolution: the exact pmf of the pinned
    pairwise box-plus replaces the signed-min pair in both DE layers."""

    def test_pair_table_matches_golden_boxplus(self):
        from ldpc_tpu.analysis import de
        Q, T = 15, (8, 3, 0)
        tab = de._minstar_pair_targets(Q, T)
        for a in range(-Q, Q + 1):
            for b in range(-Q, Q + 1):
                g = int(gold._boxplus2(np.int32(a), np.int32(b), T, Q))
                assert tab[a + Q, b + Q] - Q == g, (a, b)

    def test_empty_lut_pair_degenerates_to_signed_min(self):
        from ldpc_tpu.analysis import de
        Q = 31
        rng = np.random.default_rng(3)
        pa = rng.random(2 * Q + 1)
        pa /= pa.sum()
        pb = rng.random(2 * Q + 1)
        pb /= pb.sum()
        np.testing.assert_allclose(de._cn_pair_minstar(pa, pb, Q, ()),
                                   de._cn_pair(pa, pb, Q), atol=1e-15)

    def test_threshold_order_minsum_oms_minstar(self):
        # min* approaches sum-product: its DE threshold must beat OMS,
        # which beats plain min-sum — mirroring the silicon BER order.
        from ldpc_tpu.analysis import de
        q = QuantConfig(bits=6, scale=4.0, beta_lsb=0)
        sp = de.regular_spectra(3, 6)
        s_ms = de.de_threshold_awgn_spectra(sp, q, beta=0)
        s_oms = de.de_threshold_awgn_spectra(sp, q, beta=1)
        s_star = de.de_threshold_awgn_spectra(
            sp, q, beta=0, minstar=minstar_thresholds(q))
        assert s_ms < s_oms < s_star

    def test_rejects_beta_alpha(self):
        from ldpc_tpu.analysis import de
        q = QuantConfig(bits=6, scale=4.0)
        with pytest.raises(ValueError, match="beta/alpha"):
            de.de_pe_trajectory_spectra(
                de.chan_pmf_awgn(0.8, q), de.regular_spectra(3, 6),
                beta=1, qmax=q.qmax, minstar=(8, 3, 0))

    def test_proto_regular_collapse(self):
        # a fully regular base + uniform channel must collapse to the
        # single-edge recursion exactly (same invariant the min-sum proto
        # DE pins in test_proto_de)
        from ldpc_tpu.analysis import de
        from ldpc_tpu.analysis.proto_de import proto_de_trajectory
        q = QuantConfig(bits=5, scale=4.0, beta_lsb=0)
        ms = minstar_thresholds(q)
        Q = q.qmax
        base = np.zeros((2, 4), np.int64)  # dv=2, dc=4 regular
        chan = de.chan_pmf_awgn(0.7, q)
        tr_p = proto_de_trajectory(base, np.tile(chan, (4, 1)), qmax=Q,
                                   iters=6, minstar=ms)
        tr_s = de.de_pe_trajectory_spectra(chan, de.regular_spectra(2, 4),
                                           qmax=Q, iters=6, minstar=ms)
        np.testing.assert_allclose(tr_p, tr_s[:len(tr_p)], atol=1e-12)


class TestQCMinstar:
    """min* stays on the QC-XLA decoder on every platform (the CUDA kernel
    covers the min-sum family only)."""

    def test_rejects_beta_alpha_combination(self):
        from ldpc_tpu.ops.decode_qc import make_qc_decoder
        with pytest.raises(ValueError, match="beta/alpha"):
            make_qc_decoder(toy_qc(8), beta=1, minstar=(8, 3, 0))

    def test_gpu_auto_routes_to_qc_jnp(self, monkeypatch):
        import jax

        from ldpc_tpu.sim.pipeline import select_decoder
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        cfg = SimConfig(code=CodeConfig(),
                        decoder=DecoderConfig(algorithm="min-star"))
        _, label = select_decoder(make_wifi(648, "1/2"), cfg, "auto")
        assert label == "qc-jnp"


class TestOracleMinstar:
    """Round-5 native-C oracle min* (csrc/ldpc_oracle.c cn_update_minstar)
    — the fourth bit-exact implementation of the pinned semantics."""

    @pytest.mark.parametrize("schedule", ["flooding", "layered"])
    def test_oracle_matches_golden(self, schedule):
        from ldpc_tpu import oracle
        code = toy_qc(8)
        q = QuantConfig(bits=6, scale=4.0)
        T = minstar_thresholds(q)
        rng = np.random.default_rng(11)
        chan = rng.integers(-20, 20, (32, code.n)).astype(np.int8)
        h, it, cv = oracle.decode_batch(chan, code, max_iter=6,
                                        qmax=q.qmax, schedule=schedule,
                                        minstar=T)
        for b in range(8):
            g = gold.decode_fixed(chan[b].astype(np.int32), code,
                                  max_iter=6, qmax=q.qmax,
                                  schedule=schedule, minstar=T)
            np.testing.assert_array_equal(h[b], g.hard)
            assert it[b] == g.iters and bool(cv[b]) == g.converged

    def test_oracle_rejects_beta_combination(self):
        from ldpc_tpu import oracle
        with pytest.raises(ValueError, match="beta/alpha"):
            oracle.decode_batch(np.zeros((2, 24), np.int8), toy_qc(8),
                                beta=1, minstar=(8, 3, 0))


class TestPipelineIntegration:
    def _cfg(self, **dec_kw):
        return SimConfig(code=CodeConfig(),
                         decoder=DecoderConfig(algorithm="min-star",
                                               max_iter=10, **dec_kw))

    def test_select_decoder_routes_to_qc_on_cpu(self):
        # "auto" resolves to the QC-XLA backend (the edge-gather jnp
        # decoder has no min* update, the CUDA kernel no min* variant).
        from ldpc_tpu.sim.pipeline import select_decoder
        code = make_wifi(648, "1/2")
        dec, label = select_decoder(code, self._cfg(), "auto", batch=64)
        assert label == "qc-jnp"
        out = dec(jnp.zeros((4, code.n), jnp.int8))
        assert np.asarray(out[0]).shape == (4, code.n)

    def test_non_qc_code_rejected(self):
        from ldpc_tpu.codes.code import LDPCCode
        from ldpc_tpu.sim.pipeline import select_decoder
        cn = [np.array([0, 1, 2], np.int32), np.array([1, 2, 3], np.int32)]
        code = LDPCCode(name="nonqc", n=4, m=2, k=2, cn_adj=cn)
        with pytest.raises(ValueError, match="QC"):
            select_decoder(code, self._cfg(), "auto", batch=8)

    @pytest.mark.slow
    def test_sweep_end_to_end(self):
        from ldpc_tpu.sim.sweep import Sweep
        cfg = dataclasses.replace(
            self._cfg(schedule="layered"),
            run=__import__("ldpc_tpu.config", fromlist=["RunConfig"]
                           ).RunConfig(batch=256, seed=2))
        res = Sweep(cfg, decoder_backend="auto").run(
            [2.0], target_frame_errors=10 ** 9, max_frames=512)
        assert res.decoder_backend == "qc-jnp"
        assert res.points[0].frames == 512

    @pytest.mark.slow
    def test_minstar_beats_minsum_ber(self):
        # min* approaches sum-product; at 8 bits it must not lose to
        # plain min-sum (the classic ~0.2-0.3 dB win). Same seed/noise.
        from ldpc_tpu.sim.sweep import Sweep
        from ldpc_tpu.config import RunConfig
        errs = {}
        for alg in ("min-star", "min-sum"):
            cfg = SimConfig(code=CodeConfig(),
                            decoder=DecoderConfig(algorithm=alg,
                                                  max_iter=10,
                                                  schedule="layered"),
                            run=RunConfig(batch=512, seed=9))
            res = Sweep(cfg, decoder_backend="auto").run(
                [1.5], target_frame_errors=10 ** 9, max_frames=2048)
            errs[alg] = res.points[0].bit_errs
        assert errs["min-star"] < errs["min-sum"]
