"""Density-evolution tests (analysis/de.py) — round-2 advisor finding (the
module shipped untested) + round-3 irregular-spectrum extension (VERDICT
item 7: thresholds must apply to the actual 802.11n/NR/DVB-S2 profiles).

Pins: the classic Gallager-A (3,6) BSC threshold p* ~= 0.0394 (Gallager
1963 / Bazzi et al. exact value 0.0394636...); regular == one-hot-spectrum
equivalence; trajectory monotonicity across the threshold; and the 802.11n
OMS AWGN threshold's DIRECTION against the measured waterfall artifact
(asymptotic threshold must sit below the finite-length n=648 waterfall,
above the Shannon limit).
"""
import math

import numpy as np
import pytest

from ldpc_tpu.analysis import de
from ldpc_tpu.config import QuantConfig


class TestGallagerDE:
    def test_gallager_a_36_threshold_pinned(self):
        th = de.gallager_threshold(3, 6, "gallager-a", tol=1e-5)
        assert abs(th - 0.03946) < 5e-4

    def test_gallager_48_thresholds(self):
        # (4,8) with the strong rule t=3 (= Gallager-A for dv=4): the known
        # ~0.046 threshold; the weak majority rule t=2 is far worse (known
        # ~0.0077) — pins the per-degree threshold plumbing both ways.
        t3 = de.gallager_threshold(4, 8, "gallager-b", threshold=3)
        t2 = de.gallager_threshold(4, 8, "gallager-b")
        assert abs(t3 - 0.046) < 1e-3
        assert t2 < 0.01

    def test_trajectory_direction(self):
        th = de.gallager_threshold(3, 6, "gallager-a")
        below = de.gallager_trajectory(th * 0.9, 3, 6, "gallager-a")
        above = de.gallager_trajectory(min(th * 1.3, 0.49), 3, 6,
                                       "gallager-a")
        assert below[-1] < 1e-10
        assert above[-1] > 1e-3

    def test_regular_equals_one_hot_spectra(self):
        sp = de.regular_spectra(3, 6)
        t1 = de.gallager_trajectory(0.03, 3, 6, "gallager-b")
        t2 = de.gallager_trajectory_spectra(0.03, sp, "gallager-b")
        np.testing.assert_allclose(t1, t2, rtol=0, atol=0)

    def test_irregular_spectra_from_code(self):
        """spectra_from_code on the regular array code gives exactly the
        one-hot regular spectra; on 802.11n it reflects the irregular
        profile (degree-2 staircase variables present)."""
        from ldpc_tpu.codes.toy import array_qc
        from ldpc_tpu.codes.ieee80211n import make_code
        sp = de.spectra_from_code(array_qc(3, 6, 17))
        assert sp.max_dv == 3 and sp.max_dc == 6
        assert sp.lam[3] == 1.0 and sp.rho[6] == 1.0
        spw = de.spectra_from_code(make_code(648, "1/2"))
        assert spw.lam[2] > 0 and spw.max_dv >= 11
        assert abs(spw.lam.sum() - 1) < 1e-12
        assert abs(spw.rho.sum() - 1) < 1e-12
        assert abs(spw.vnode.sum() - 1) < 1e-12


class TestQuantizedDE:
    QUANT = QuantConfig(bits=8, scale=4.0, beta_lsb=0)

    def test_pe_trajectory_monotone_direction(self):
        pmf_good = de.chan_pmf_awgn(0.7, self.QUANT)
        pmf_bad = de.chan_pmf_awgn(1.3, self.QUANT)
        good = de.de_pe_trajectory(pmf_good, 3, 6, qmax=127, iters=60)
        bad = de.de_pe_trajectory(pmf_bad, 3, 6, qmax=127, iters=60)
        assert good[-1] < 1e-10
        assert bad[-1] > 1e-3
        # below threshold the trajectory is (weakly) decreasing
        assert np.all(np.diff(good) <= 1e-12)

    def test_regular_equals_one_hot_spectra(self):
        pmf = de.chan_pmf_awgn(0.8, self.QUANT)
        t1 = de.de_pe_trajectory(pmf, 3, 6, beta=1, qmax=127, iters=8)
        t2 = de.de_pe_trajectory_spectra(pmf, de.regular_spectra(3, 6),
                                         beta=1, qmax=127, iters=8)
        np.testing.assert_allclose(t1, t2, rtol=0, atol=1e-15)

    def test_bsc_zero_quant_raises(self):
        """Round-2 advisor finding: a channel magnitude that quantizes to 0
        must be refused, not silently report convergence."""
        q1 = QuantConfig(bits=8, scale=1.0, beta_lsb=0)
        with pytest.raises(ValueError, match="quantizes to 0"):
            de.chan_pmf_bsc(0.39, q1)

    def test_bsc_threshold_bracket_past_zero_quant(self):
        """Round-3 advisor finding: a bisection bracket whose upper portion
        quantizes the BSC LLR magnitude to 0 must not abort the threshold
        search — those points are treated as non-converged (hi shrinks)."""
        q1 = QuantConfig(bits=8, scale=1.0, beta_lsb=0)
        # At scale 1.0, p >= ~0.27 quantizes log((1-p)/p) to 0 (raises in
        # chan_pmf_bsc); a representable threshold still exists below it.
        p = de.de_threshold_bsc(3, 6, q1, iters=60, tol=1e-3,
                                bracket=(1e-3, 0.39))
        assert 1e-3 < p < 0.27

    def test_pmfs_normalized(self):
        pmf = de.chan_pmf_awgn(0.9, self.QUANT)
        assert abs(pmf.sum() - 1) < 1e-12
        pmf2 = de.chan_pmf_bsc(0.05, self.QUANT)
        assert abs(pmf2.sum() - 1) < 1e-12


class TestIrregularThresholds:
    """The headline use: thresholds for the PRODUCTION irregular profiles."""

    def test_wifi648_oms_threshold_vs_waterfall(self):
        """802.11n n=648 r=1/2, 8-bit OMS beta=1 (the measured artifact
        results/cn_variants_oms_b1.json: BER 1.3e-2 at 1.5 dB, 1.1e-3 at
        2.0 dB, 20 iters). The DE threshold is an ensemble asymptote: it
        must sit BELOW the finite-length waterfall (< 2.0 dB) and above
        the r=1/2 BPSK Shannon limit (0.188 dB)."""
        from ldpc_tpu.codes.ieee80211n import make_code
        code = make_code(648, "1/2")
        sp = de.spectra_from_code(code)
        quant = QuantConfig(bits=8, scale=4.0, beta_lsb=1)
        sigma_star = de.de_threshold_awgn_spectra(
            sp, quant, beta=1, iters=80, tol=5e-3, bracket=(0.6, 1.3))
        rate = code.k / code.n
        ebn0_star = -20.0 * math.log10(sigma_star * math.sqrt(2 * rate))
        assert 0.188 < ebn0_star < 2.0, ebn0_star

    def test_irregular_beats_wrong_regular_proxy(self):
        """The whole point of the extension: the irregular 802.11n profile
        has a different (better) threshold than the (3,6)-regular proxy a
        regular-only DE would force."""
        from ldpc_tpu.codes.ieee80211n import make_code
        sp = de.spectra_from_code(make_code(648, "1/2"))
        quant = QuantConfig(bits=8, scale=4.0, beta_lsb=1)
        kw = dict(beta=1, iters=60, tol=1e-2, bracket=(0.6, 1.3))
        s_irr = de.de_threshold_awgn_spectra(sp, quant, **kw)
        s_reg = de.de_threshold_awgn_spectra(de.regular_spectra(3, 6),
                                             quant, **kw)
        # larger tolerable sigma = better threshold
        assert s_irr > s_reg


class TestDecisionWeights:
    def test_min_degree_weights(self):
        from ldpc_tpu.codes.nr_bg import make_code as nrbg
        sp = de.spectra_from_code(nrbg(base_graph=2, Z=16))
        w = de.decision_weights_min_degree(sp, 2)
        assert w[1] == 0 and abs(w.sum() - 1) < 1e-12
        with pytest.raises(AssertionError):
            de.decision_weights_min_degree(sp, sp.max_dv + 1)

    def test_nr_deg1_floor_vs_info_degrees(self):
        """NR BG2's degree-1 extension parities give the NODE-average Pe an
        irreducible floor; the degree>=2 decision average converges orders
        of magnitude lower at the same channel (the info-bit view)."""
        from ldpc_tpu.codes.nr_bg import make_code as nrbg
        from ldpc_tpu.config import QuantConfig
        q = QuantConfig(bits=8, scale=4.0, beta_lsb=2)
        sp = de.spectra_from_code(nrbg(base_graph=2, Z=16))
        pmf = de.chan_pmf_awgn(0.7, q)
        pe_all = de.de_pe_trajectory_spectra(pmf, sp, beta=2, qmax=q.qmax,
                                             iters=80)[-1]
        w = de.decision_weights_min_degree(sp, 2)
        pe_info = de.de_pe_trajectory_spectra(pmf, sp, beta=2, qmax=q.qmax,
                                              iters=80,
                                              decision_vnode=w)[-1]
        assert pe_all > 1e-3
        assert pe_info < pe_all / 10
