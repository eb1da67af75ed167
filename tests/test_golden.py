"""Stage-1 tests: golden model semantics (SURVEY.md §4.2 rows 'quantizer',
'decoder kernel' oracle side)."""
import numpy as np
import pytest

from ldpc_tpu.codes.code import gf2_rank, has_4cycle
from ldpc_tpu.codes.toy import hamming74, toy_qc
from ldpc_tpu.golden import decode_fixed, decode_float, encode, quantize


def bpsk_llr(bits, sigma, rng):
    x = 1.0 - 2.0 * bits.astype(np.float64)
    y = x + sigma * rng.standard_normal(x.shape)
    return 2.0 * y / sigma**2


class TestQuantizer:
    def test_saturation_symmetric(self):
        q = quantize(np.array([1000.0, -1000.0, 0.0]), scale=4.0, bits=8)
        assert q.tolist() == [127, -127, 0]

    def test_round_half_away_from_zero(self):
        # 0.125*4 = 0.5 -> 1 ; -0.125*4 = -0.5 -> -1
        q = quantize(np.array([0.125, -0.125, 0.1, -0.1]), scale=4.0)
        assert q.tolist() == [1, -1, 0, 0]

    def test_scale(self):
        q = quantize(np.array([2.0, -3.25]), scale=4.0)
        assert q.tolist() == [8, -13]


class TestCodesToy:
    def test_hamming_structure(self):
        c = hamming74()
        assert (c.n, c.m, c.k) == (7, 3, 4)
        assert gf2_rank(c.h_dense()) == 3

    def test_toy_qc_structure(self):
        c = toy_qc(Z=4)
        assert (c.n, c.m, c.k) == (24, 12, 12)
        assert gf2_rank(c.h_dense()) == 12
        assert not has_4cycle(c)

    def test_encoder_property(self, rng):
        for code in [hamming74(), toy_qc(4), toy_qc(8)]:
            info = rng.integers(0, 2, size=(16, code.k)).astype(np.uint8)
            cw = encode(code, info)
            H = code.h_dense()
            assert np.all((cw @ H.T) % 2 == 0)
            # systematic: info bits recoverable from first k positions (perm
            # is identity for these codes)
            assert np.all(cw[:, : code.k] == info)


class TestGoldenDecoder:
    @pytest.mark.parametrize("schedule", ["flooding", "layered"])
    def test_noiseless_zero_iteration_convergence(self, schedule):
        code = toy_qc(4)
        chan = np.full(code.n, 30, np.int32)  # strong all-zeros codeword
        res = decode_fixed(chan, code, max_iter=20, schedule=schedule)
        assert res.converged
        assert res.iters == 0  # syndrome already satisfied pre-iteration
        assert not res.hard.any()

    @pytest.mark.parametrize("schedule", ["flooding", "layered"])
    @pytest.mark.parametrize("beta", [0, 2])
    def test_corrects_noisy_codewords(self, schedule, beta, rng):
        code = toy_qc(4)
        sigma = 0.7
        ok = 0
        trials = 60
        for _ in range(trials):
            info = rng.integers(0, 2, code.k).astype(np.uint8)
            cw = encode(code, info)
            llr = bpsk_llr(cw, sigma, rng)
            chan = quantize(llr, scale=4.0)
            res = decode_fixed(chan, code, max_iter=30, beta=beta,
                               schedule=schedule)
            if np.array_equal(res.hard, cw):
                ok += 1
        # channel BER ~ Q(1/0.7) ~ 7.7%; a rate-1/2 LDPC at this SNR should
        # decode the large majority of 24-bit frames.
        assert ok > trials * 0.7, f"{ok}/{trials}"

    def test_converged_implies_syndrome(self, rng):
        code = hamming74()
        for _ in range(50):
            info = rng.integers(0, 2, code.k).astype(np.uint8)
            cw = encode(code, info)
            chan = quantize(bpsk_llr(cw, 1.0, rng), scale=4.0)
            res = decode_fixed(chan, code, max_iter=10)
            if res.converged:
                assert not code.syndrome(res.hard).any()

    def test_layered_converges_faster_on_average(self, rng):
        code = toy_qc(8)
        iters_f, iters_l = [], []
        for _ in range(40):
            info = rng.integers(0, 2, code.k).astype(np.uint8)
            cw = encode(code, info)
            chan = quantize(bpsk_llr(cw, 0.8, rng), scale=4.0)
            rf = decode_fixed(chan, code, max_iter=30, schedule="flooding")
            rl = decode_fixed(chan, code, max_iter=30, schedule="layered")
            if rf.converged and rl.converged:
                iters_f.append(rf.iters)
                iters_l.append(rl.iters)
        assert len(iters_f) > 10
        assert np.mean(iters_l) <= np.mean(iters_f)

    def test_float_beats_or_matches_fixed(self, rng):
        """Fixed-point quantization bound: float decoder is at least as good."""
        code = toy_qc(4)
        sigma = 0.85
        fixed_err = float_err = 0
        for _ in range(80):
            info = rng.integers(0, 2, code.k).astype(np.uint8)
            cw = encode(code, info)
            llr = bpsk_llr(cw, sigma, rng)
            rfix = decode_fixed(quantize(llr, 4.0), code, max_iter=25)
            rflt = decode_float(llr, code, max_iter=25)
            fixed_err += int(not np.array_equal(rfix.hard, cw))
            float_err += int(not np.array_equal(rflt.hard, cw))
        assert float_err <= fixed_err + 3  # statistical slack

    def test_posterior_bound_no_overflow(self, rng):
        """Posterior magnitude bounded by qmax*(dv+1) < 2**15 — certifies the
        int16 posterior width used by the CUDA kernel (BASELINE.json:5
        'verified overflow behavior')."""
        code = toy_qc(4)
        max_dv = max(len(a) for a in code.vn_adj())
        bound = 127 * (max_dv + 1)
        assert bound < 2 ** 15
        for _ in range(10):
            info = rng.integers(0, 2, code.k).astype(np.uint8)
            cw = encode(code, info)
            chan = quantize(bpsk_llr(cw, 0.9, rng), scale=4.0)
            res = decode_fixed(chan, code, max_iter=15, trace=True)
            for t in res.trace or []:
                assert np.abs(t["total"]).max() <= bound
