"""Generic rate-compatible puncturing/shortening (codes/rate_compat.py):
rate math, nesting, decoder-graph reuse, and end-to-end pipeline counters.
The 5G NR builder covers the standard's own rate matching; these tests
cover the family-agnostic mechanism layered on top."""

import numpy as np
import pytest

from ldpc_tpu.codes.ieee80211n import make_code as make_wifi
from ldpc_tpu.codes.rate_compat import (
    puncture,
    puncture_order,
    rate_ladder,
    shorten,
)
from ldpc_tpu.config import CodeConfig, RunConfig, SimConfig
from ldpc_tpu.golden import encoder as golden_enc
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.sim.sweep import build_code


@pytest.fixture(scope="module")
def wifi648():
    return make_wifi(648, "1/2")


class TestPunctureMath:
    def test_count(self, wifi648):
        p = puncture(wifi648, count=81)
        assert p.n == wifi648.n and p.k == wifi648.k  # same decoder graph
        assert len(p.punct_vns) == 81
        assert p.n_tx == 648 - 81
        assert p.rate == pytest.approx(324 / 567)
        # mother untouched
        assert len(wifi648.punct_vns) == 0

    def test_frac_and_rate_equivalent(self, wifi648):
        by_frac = puncture(wifi648, frac=0.25)
        assert len(by_frac.punct_vns) == 81
        by_rate = puncture(wifi648, rate=324 / 567)
        assert np.array_equal(by_rate.punct_vns, by_frac.punct_vns)

    def test_tail_scheme_punctures_codeword_tail(self, wifi648):
        p = puncture(wifi648, count=54, scheme="tail")
        assert set(map(int, p.punct_vns)) == set(range(648 - 54, 648))

    def test_random_scheme_seeded(self, wifi648):
        a = puncture(wifi648, count=50, scheme="random", seed=7)
        b = puncture(wifi648, count=50, scheme="random", seed=7)
        c = puncture(wifi648, count=50, scheme="random", seed=8)
        assert np.array_equal(a.punct_vns, b.punct_vns)
        assert not np.array_equal(a.punct_vns, c.punct_vns)
        # never punctures information positions
        assert (np.asarray(a.punct_vns) >= wifi648.k).all()

    def test_nesting(self, wifi648):
        lo = puncture(wifi648, count=30, scheme="random", seed=3)
        hi = puncture(wifi648, count=90, scheme="random", seed=3)
        assert set(map(int, lo.punct_vns)) <= set(map(int, hi.punct_vns))

    def test_ladder_nested_and_rates(self, wifi648):
        rates = [0.5, 0.6, 0.7]
        fam = rate_ladder(wifi648, rates)
        assert fam[0] is wifi648
        prev = set()
        for code, r in zip(fam, rates):
            assert code.rate == pytest.approx(r, abs=0.003)
            cur = set(map(int, code.punct_vns))
            assert prev <= cur
            prev = cur

    def test_rejects(self, wifi648):
        with pytest.raises(ValueError):
            puncture(wifi648, count=10, frac=0.1)
        with pytest.raises(ValueError):
            puncture(wifi648, frac=1.0)
        with pytest.raises(ValueError):
            puncture(wifi648, rate=0.4)  # below mother rate
        with pytest.raises(ValueError):
            puncture(wifi648, count=324)  # rate would reach 1
        with pytest.raises(ValueError):
            puncture_order(wifi648, scheme="zigzag")


class TestShorten:
    def test_math(self, wifi648):
        s = shorten(wifi648, 100)
        assert s.k_eff == wifi648.k - 100
        assert s.n_tx == wifi648.n - 100
        assert s.rate == pytest.approx(224 / 548)
        with pytest.raises(ValueError):
            shorten(wifi648, wifi648.k)


class TestDecodeRecovery:
    def test_punctured_bits_recovered_noiseless(self, wifi648):
        # Tail puncturing: decoder sees LLR 0 at punctured positions yet
        # must reproduce the full codeword from the clean remainder.
        p = puncture(wifi648, count=81)
        rng = np.random.default_rng(0)
        info = rng.integers(0, 2, wifi648.k)
        cw = golden_enc.encode(wifi648, info)
        llr = (1 - 2 * cw.astype(np.int32)) * 24
        llr[np.asarray(p.punct_vns)] = 0
        res = decode_fixed(llr, p, max_iter=20, beta=2)
        assert res.converged
        assert (res.hard == cw).all()


class TestPipelineIntegration:
    def test_build_code_applies_puncture(self):
        cfg = SimConfig(code=CodeConfig(punct_frac=0.25))
        code = build_code(cfg)
        assert len(code.punct_vns) == 81 and code.n_tx == 567

    def test_sweep_counters(self):
        from ldpc_tpu.sim.sweep import Sweep
        cfg = SimConfig(
            code=CodeConfig(punct_frac=0.125),
            run=RunConfig(batch=256, max_frames=256, target_frame_errors=4),
        )
        sw = Sweep(cfg, decoder_backend="jnp")
        res = sw.run([4.0])
        pt = res.points[0]
        assert pt.frames == 256
        assert 0 <= pt.frame_errs <= 256

    def test_config_json_roundtrip(self):
        cfg = SimConfig(code=CodeConfig(punct_frac=0.2,
                                        punct_scheme="random"))
        assert SimConfig.from_json(cfg.to_json()) == cfg

    def test_cli_flags(self):
        from ldpc_tpu.cli import _build_config, build_parser
        args = build_parser().parse_args(
            ["sweep", "--puncture-frac", "0.25",
             "--puncture-scheme", "random"])
        cfg = _build_config(args)
        assert cfg.code.punct_frac == 0.25
        assert cfg.code.punct_scheme == "random"


class TestShortenConfig:
    def test_build_code_shorten(self):
        cfg = SimConfig(code=CodeConfig(shorten_bits=100))
        code = build_code(cfg)
        assert code.k_eff == 224 and code.n_tx == 548

    def test_shorten_sweep_counters(self):
        from ldpc_tpu.sim.sweep import Sweep
        cfg = SimConfig(
            code=CodeConfig(shorten_bits=64, punct_frac=0.125),
            run=RunConfig(batch=128, max_frames=128, target_frame_errors=4),
        )
        sw = Sweep(cfg, decoder_backend="jnp")
        pt = sw.run([4.0]).points[0]
        assert pt.frames == 128 and 0 <= pt.frame_errs <= 128

    def test_cli_flag(self):
        from ldpc_tpu.cli import _build_config, build_parser
        args = build_parser().parse_args(["sweep", "--shorten-bits", "32"])
        assert _build_config(args).code.shorten_bits == 32


class TestFloorCLI:
    def test_floor_smoke(self, tmp_path, capsys):
        import json
        from ldpc_tpu.cli import main
        out = str(tmp_path / "floor.json")
        rc = main(["floor", "--platform", "cpu",
                   "--algorithm", "normalized-min-sum", "--beta-lsb", "0",
                   "--schedule", "layered",
                   "--harvest-ebn0", "2.2", "--harvest-frames", "1024",
                   "--batch", "256", "--frames", "512",
                   "--ebn0", "3.0", "--out", out])
        assert rc == 0
        d = json.load(open(out))
        assert d["points"][0]["frames"] == 512
        assert d["points"][0]["fer"] >= 0
        assert d["proposal"]["n_sets"] >= 0

    def test_floor_symmetric_smoke(self, tmp_path):
        """floor --symmetric (round 5): orbit folding + the seed-
        repeatability bar on the product surface."""
        import json
        from ldpc_tpu.cli import main
        out = str(tmp_path / "floor_sym.json")
        rc = main(["floor", "--platform", "cpu",
                   "--algorithm", "normalized-min-sum", "--beta-lsb", "0",
                   "--schedule", "layered",
                   "--harvest-ebn0", "2.2", "--harvest-frames", "1024",
                   "--batch", "256", "--frames", "512",
                   "--ebn0", "3.0", "--symmetric", "--seeds", "5,6",
                   "--delta", "1.2,1.8", "--out", out])
        assert rc == 0
        d = json.load(open(out))
        assert d["proposal"]["estimator"].startswith("symmetry-folded")
        assert d["proposal"]["orbit_multiplier"] == 27
        pt = d["points"][0]
        assert len(pt["seeds"]) == 2
        assert pt["seed_repeatable"] in (True, False)
        for r in pt["seeds"]:
            assert r["fer"] >= 0 and r["frames"] == 512
