"""PEG / QC-PEG code construction tests (SURVEY.md §1.2 'H-matrix
generation' role; §8.1 PEG fallback policy).

Oracles: exact girth by BFS, GF(2) rank, H c^T = 0 via the golden encoder,
and bit-exact decode equality golden vs the batched jnp decoder on a
constructed code (constructed codes must be first-class citizens of every
decode path)."""
import numpy as np
import pytest

from ldpc_tpu.codes.code import gf2_rank, has_4cycle
from ldpc_tpu.codes.peg import (
    degrees_from_profile,
    girth,
    peg_construct,
    qc_peg_construct,
)
from ldpc_tpu.codes.qcstruct import base_collisions, detect_enc_struct
from ldpc_tpu.golden import encoder as golden_enc
from ldpc_tpu.golden.decoder import decode_fixed, quantize


class TestDegreesFromProfile:
    def test_exact_counts(self):
        d = degrees_from_profile(12, {2: 0.5, 3: 0.25, 8: 0.25})
        assert len(d) == 12 and sorted(d) == list(d)
        assert list(np.bincount(d)[[2, 3, 8]]) == [6, 3, 3]

    def test_largest_remainder(self):
        d = degrees_from_profile(10, {2: 1 / 3, 3: 1 / 3, 4: 1 / 3})
        assert len(d) == 10 and d.sum() in (29, 30, 31)
        assert set(np.unique(d)) == {2, 3, 4}

    def test_rejects_bad_profile(self):
        with pytest.raises(ValueError):
            degrees_from_profile(10, {3: 0.5})


class TestGirthOracle:
    def test_known_girth_cycle_code(self):
        # A single 6-cycle Tanner graph: 3 VNs, 3 CNs, each CN joins 2 VNs.
        from ldpc_tpu.codes.code import LDPCCode
        cn = [np.array([0, 1], np.int32), np.array([1, 2], np.int32),
              np.array([0, 2], np.int32)]
        code = LDPCCode(name="c6", n=3, m=3, k=0, cn_adj=cn)
        assert girth(code) == 6

    def test_4cycle_detected(self):
        from ldpc_tpu.codes.code import LDPCCode
        cn = [np.array([0, 1], np.int32), np.array([0, 1], np.int32)]
        code = LDPCCode(name="c4", n=2, m=2, k=0, cn_adj=cn)
        assert girth(code) == 4

    def test_matches_has_4cycle_on_wifi(self):
        from ldpc_tpu.codes.ieee80211n import make_code
        code = make_code(648, "1/2")
        g = girth(code)
        assert g >= 6 and not has_4cycle(code)


class TestPEGUnstructured:
    def test_regular_36(self):
        code = peg_construct(96, 48, 3, seed=1)
        assert code.n == 96 and code.m == 48 and code.k == 48
        assert gf2_rank(code.h_dense()) == 48
        assert girth(code) >= 6
        # exact VN degrees
        vn_deg = np.zeros(96, int)
        for vs in code.cn_adj:
            vn_deg[vs] += 1
        assert (vn_deg == 3).all()
        # near-uniform CN degrees (PEG's min-degree tie-break concentrates
        # them, but distance dominates once all checks are reachable)
        cn_deg = np.array([len(a) for a in code.cn_adj])
        assert cn_deg.max() - cn_deg.min() <= 2
        assert not code.standard_exact

    def test_irregular_profile_and_encode(self):
        # Profile sized so girth 6 is achievable (a high-degree VN whose
        # distance-3 neighborhood covers every check FORCES a 4-cycle —
        # e.g. degree 7 at m=60 measures girth 4; that is graph physics,
        # not a constructor defect).
        code = peg_construct(200, 100, {2: 0.5, 3: 0.35, 5: 0.15}, seed=3)
        assert girth(code) >= 6
        info = np.random.default_rng(0).integers(0, 2, (4, code.k))
        cw = golden_enc.encode(code, info)
        assert (code.syndrome(cw) == 0).all()

    def test_decodes_noiseless(self):
        code = peg_construct(96, 48, 3, seed=1)
        info = np.random.default_rng(1).integers(0, 2, code.k)
        cw = golden_enc.encode(code, info)
        llr = quantize((1.0 - 2.0 * cw) * 8.0)
        res = decode_fixed(llr, code, max_iter=5)
        assert res.converged and (res.hard == cw).all()

    def test_rejects_bad_degrees(self):
        with pytest.raises(ValueError):
            peg_construct(10, 5, 6, seed=0)  # degree > m
        with pytest.raises(ValueError):
            peg_construct(10, 5, [3] * 9, seed=0)  # wrong length


class TestQCPEG:
    def test_girth8_at_wifi_size(self):
        # The headline: at the 802.11n n=648 r=1/2 geometry the QC-PEG
        # constructor reaches girth 8 where the standard table has girth 6.
        code = qc_peg_construct(kb=12, cb=12, Z=27,
                                col_degrees=[2] * 6 + [3] * 4 + [8] * 2,
                                seed=0)
        assert code.n == 648 and code.m == 324
        assert girth(code) >= 8
        assert not base_collisions(code.base, 27)
        assert gf2_rank(code.h_dense()) == code.m

    def test_encodable_structure(self):
        code = qc_peg_construct(kb=12, cb=12, Z=27, col_degrees=3, seed=2)
        st = detect_enc_struct(code.base)
        assert st is not None and st.kb == 12 and st.cb == 12
        # structured O(E) encoder agrees with the property H c^T = 0
        from ldpc_tpu.codes.qcstruct import qc_encode_numpy
        info = np.random.default_rng(2).integers(0, 2, (3, code.k))
        cw = qc_encode_numpy(code, info)
        assert (code.syndrome(cw) == 0).all()

    def test_extension_rows(self):
        code = qc_peg_construct(kb=8, cb=4, Z=16, col_degrees=3, mb=6, seed=1)
        assert code.base.shape == (6, 14)
        st = detect_enc_struct(code.base)
        assert st is not None and st.cb == 4
        assert girth(code) >= 6

    def test_profile_dict(self):
        code = qc_peg_construct(kb=12, cb=12, Z=27,
                                col_degrees={2: 0.5, 3: 0.25, 8: 0.25},
                                seed=0)
        col_deg = (code.base[:, :12] >= 0).sum(axis=0)
        assert sorted(col_deg) == [2, 2, 2, 2, 2, 2, 3, 3, 3, 8, 8, 8]

    def test_rejects_degree_bounds(self):
        with pytest.raises(ValueError):
            qc_peg_construct(kb=4, cb=4, Z=8, col_degrees=1, seed=0)
        with pytest.raises(ValueError):
            qc_peg_construct(kb=4, cb=4, Z=8, col_degrees=5, seed=0)

    def test_jnp_decoder_bit_exact_on_constructed_code(self):
        # Constructed codes ride the same decode paths: golden == jnp,
        # identical hard bits/iters on noisy inputs.
        import jax.numpy as jnp
        from ldpc_tpu.config import DecoderConfig, QuantConfig
        from ldpc_tpu.ops.decode_ref import make_decoder
        code = qc_peg_construct(kb=12, cb=12, Z=27, col_degrees=3, seed=4)
        rng = np.random.default_rng(0)
        chan = rng.integers(-31, 32, (4, code.n)).astype(np.int8)
        dec = make_decoder(code,
                           DecoderConfig(algorithm="offset-min-sum",
                                         max_iter=8),
                           QuantConfig(beta_lsb=1))
        hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan)))
        for b in range(4):
            ref = decode_fixed(chan[b].astype(np.int32), code, max_iter=8,
                               beta=1)
            assert (hard[b] == ref.hard).all()
            assert iters[b] == ref.iters and bool(conv[b]) == ref.converged


class TestQCPEGFamilyConfig:
    def test_build_code_from_config(self):
        from ldpc_tpu.config import CodeConfig, SimConfig
        from ldpc_tpu.sim.sweep import build_code
        cfg = SimConfig(code=CodeConfig(family="qcpeg", n=648, rate="1/2",
                                        Z=27, profile="2:0.5,3:0.3,8:0.2",
                                        code_seed=1))
        a = build_code(cfg)
        b = build_code(cfg)
        assert a.n == 648 and a.k == 324 and not a.standard_exact
        # deterministic from config (checkpoint/resume identity)
        assert all(np.array_equal(x, y) for x, y in zip(a.cn_adj, b.cn_adj))

    def test_build_code_validation(self):
        from ldpc_tpu.config import CodeConfig, SimConfig
        from ldpc_tpu.sim.sweep import build_code
        with pytest.raises(ValueError):
            build_code(SimConfig(code=CodeConfig(family="qcpeg", n=648,
                                                 rate="1/2")))  # no Z
        with pytest.raises(ValueError):
            build_code(SimConfig(code=CodeConfig(family="qcpeg", n=650,
                                                 rate="1/2", Z=27)))

    def test_parse_profile(self):
        from ldpc_tpu.codes.peg import parse_profile
        assert (parse_profile(None, 4) == 3).all()
        assert sorted(parse_profile("2:0.5,4:0.5", 4)) == [2, 2, 4, 4]
        assert list(parse_profile("2,3,4,5", 4)) == [2, 3, 4, 5]
        with pytest.raises(ValueError):
            parse_profile("2,3", 4)

    def test_cli_construct(self, capsys, tmp_path):
        import json
        from ldpc_tpu.cli import main
        out = str(tmp_path / "c.alist")
        rc = main(["construct", "--family", "qcpeg", "--n", "216",
                   "--rate", "1/2", "--Z", "9", "--code-seed", "3",
                   "--export-alist", out])
        assert rc == 0
        d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert d["girth"] >= 6 and d["full_rank"]
        from ldpc_tpu.codes.alist import read_alist
        back = read_alist(out)
        assert back.n == 216 and back.m == 108


@pytest.mark.slow
class TestQCPEGDecode:
    def test_qc_decoder_bit_exact_on_constructed_code(self):
        # Constructed codes must be first-class on the QC decoder too
        # (exact equality vs golden).
        import jax.numpy as jnp
        from ldpc_tpu.ops.decode_qc import make_qc_decoder
        code = qc_peg_construct(kb=12, cb=12, Z=27, col_degrees=3, seed=4)
        rng = np.random.default_rng(3)
        chan = rng.integers(-31, 32, (4, code.n)).astype(np.int8)
        dec = make_qc_decoder(code, max_iter=6, beta=2, schedule="layered")
        hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan)))
        for b in range(4):
            ref = decode_fixed(chan[b].astype(np.int32), code, max_iter=6,
                               beta=2, schedule="layered")
            assert (hard[b] == ref.hard).all()
            assert iters[b] == ref.iters and bool(conv[b]) == ref.converged


@pytest.mark.slow
class TestPuncturedPipelineExact:
    def test_punctured_chain_jnp_equals_golden(self):
        # End-to-end punctured pipeline equality: the jnp chain's decoder
        # input (LLR 0 at punctured positions) must reproduce the golden
        # decoder bit-for-bit on identical quantized inputs.
        from ldpc_tpu.codes.ieee80211n import make_code as make_wifi
        from ldpc_tpu.codes.rate_compat import puncture
        import jax.numpy as jnp
        from ldpc_tpu.config import DecoderConfig, QuantConfig
        from ldpc_tpu.ops.decode_ref import make_decoder
        wifi = make_wifi(648, "1/2")
        p = puncture(wifi, count=81)
        rng = np.random.default_rng(5)
        chan = rng.integers(-31, 32, (3, p.n)).astype(np.int32)
        chan[:, np.asarray(p.punct_vns)] = 0
        dec = make_decoder(p, DecoderConfig(algorithm="offset-min-sum",
                                            max_iter=8),
                           QuantConfig(beta_lsb=2))
        hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan, jnp.int8)))
        for b in range(3):
            ref = decode_fixed(chan[b], p, max_iter=8, beta=2)
            assert (hard[b] == ref.hard).all() and iters[b] == ref.iters


class TestPBRL:
    def test_structure_and_ladder(self):
        from ldpc_tpu.codes.peg import pbrl_construct
        from ldpc_tpu.codes.rate_compat import rate_ladder
        code = pbrl_construct(kb=12, cb=4, Z=27, n_ext=12,
                              core_col_degrees=[3] * 9 + [4] * 3,
                              ext_row_degree=3, seed=0)
        assert code.n == 756 and code.k == 324
        assert detect_enc_struct(code.base) is not None
        assert girth(code) >= 6
        assert gf2_rank(code.h_dense()) == code.m
        # extension parity columns have degree exactly 1
        ext_cols = code.base[:, 12 + 4:]
        assert ((ext_cols >= 0).sum(axis=0) == 1).all()
        # the IR ladder: tail puncturing climbs to the core rate
        lad = rate_ladder(code, [0.5, 0.75])
        assert lad[0].rate == pytest.approx(0.5)
        assert lad[1].rate == pytest.approx(0.75)
        # the 0.75 rung punctures exactly the 12 extension parities
        assert len(lad[1].punct_vns) == 12 * 27
        assert (np.asarray(lad[1].punct_vns) >= (12 + 4) * 27).all()

    def test_encode_property(self):
        from ldpc_tpu.codes.peg import pbrl_construct
        from ldpc_tpu.codes.qcstruct import qc_encode_numpy
        code = pbrl_construct(kb=8, cb=4, Z=16, n_ext=6, seed=1)
        info = np.random.default_rng(1).integers(0, 2, (4, code.k))
        cw = qc_encode_numpy(code, info)
        assert (code.syndrome(cw) == 0).all()

    def test_decode_bit_exact(self):
        import jax.numpy as jnp
        from ldpc_tpu.codes.peg import pbrl_construct
        from ldpc_tpu.config import DecoderConfig, QuantConfig
        from ldpc_tpu.ops.decode_ref import make_decoder
        code = pbrl_construct(kb=8, cb=4, Z=16, n_ext=6, seed=1)
        rng = np.random.default_rng(2)
        chan = rng.integers(-31, 32, (3, code.n)).astype(np.int8)
        dec = make_decoder(code, DecoderConfig(algorithm="offset-min-sum",
                                               max_iter=6),
                           QuantConfig(beta_lsb=2))
        hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan)))
        for b in range(3):
            ref = decode_fixed(chan[b].astype(np.int32), code, max_iter=6,
                               beta=2)
            assert (hard[b] == ref.hard).all() and iters[b] == ref.iters

    def test_build_code_from_config(self):
        from ldpc_tpu.config import CodeConfig, SimConfig
        from ldpc_tpu.sim.sweep import build_code
        cfg = SimConfig(code=CodeConfig(family="pbrl", n=756, rate="3/7",
                                        Z=27, core_rows=4,
                                        ext_row_degree=3, code_seed=0))
        code = build_code(cfg)
        assert code.n == 756 and code.k == 324
        # punct_frac composes: 0.25 of 432 parity = 108 -> rate 0.5
        import dataclasses as dc
        cfg2 = SimConfig(code=dc.replace(cfg.code, punct_frac=0.25))
        assert build_code(cfg2).rate == pytest.approx(0.5)

    def test_rejects(self):
        from ldpc_tpu.codes.peg import pbrl_construct
        with pytest.raises(ValueError):
            pbrl_construct(kb=4, cb=2, Z=8, n_ext=2)
        with pytest.raises(ValueError):
            pbrl_construct(kb=4, cb=4, Z=8, n_ext=2, core_col_degrees=5)


@pytest.mark.slow
class TestPBRLDecode:
    def test_qc_decoder_bit_exact_on_pbrl(self):
        import jax.numpy as jnp
        from ldpc_tpu.codes.peg import pbrl_construct
        from ldpc_tpu.ops.decode_qc import make_qc_decoder
        code = pbrl_construct(kb=8, cb=4, Z=16, n_ext=6, seed=1)
        rng = np.random.default_rng(7)
        chan = rng.integers(-31, 32, (4, code.n)).astype(np.int8)
        dec = make_qc_decoder(code, max_iter=5, beta=2, schedule="layered")
        hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan)))
        for b in range(4):
            ref = decode_fixed(chan[b].astype(np.int32), code, max_iter=5,
                               beta=2, schedule="layered")
            assert (hard[b] == ref.hard).all()
            assert iters[b] == ref.iters and bool(conv[b]) == ref.converged


class TestCLIPBRLConstruct:
    def test_cli_construct_pbrl(self, capsys):
        import json
        from ldpc_tpu.cli import main
        rc = main(["construct", "--family", "pbrl", "--n", "378",
                   "--rate", "3/7", "--Z", "27", "--core-rows", "4",
                   "--ext-row-degree", "3"])
        assert rc == 0
        d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert d["n"] == 378 and d["girth"] >= 6 and d["full_rank"]


@pytest.mark.slow
class TestQCPEGLargerGeometry:
    def test_n1944_construction(self):
        # the 802.11n n=1944 r=1/2 geometry (Z=81): construction scales,
        # girth >= 6 guaranteed, encodable, full rank
        code = qc_peg_construct(kb=12, cb=12, Z=81,
                                col_degrees=[3] * 9 + [11] * 3, seed=0)
        assert code.n == 1944
        assert detect_enc_struct(code.base) is not None
        assert girth(code) >= 6
        assert gf2_rank(code.h_dense()) == code.m


class TestCycleCensus:
    def test_single_cycle_graph(self):
        from ldpc_tpu.codes.code import LDPCCode
        from ldpc_tpu.codes.peg import count_6cycles
        cn = [np.array([0, 1], np.int32), np.array([1, 2], np.int32),
              np.array([0, 2], np.int32)]
        assert count_6cycles(LDPCCode(name="c6", n=3, m=3, k=0,
                                      cn_adj=cn)) == 1

    def test_matches_bruteforce(self):
        import itertools
        from ldpc_tpu.codes.code import LDPCCode
        from ldpc_tpu.codes.peg import count_6cycles
        rng = np.random.default_rng(0)
        cn = [np.sort(rng.choice(12, 3, replace=False)).astype(np.int32)
              for _ in range(8)]
        code = LDPCCode(name="r", n=12, m=8, k=4, cn_adj=cn)
        vn = code.vn_adj()
        brute = 0
        for trio in itertools.combinations(range(12), 3):
            for (va, vb, vc) in set(itertools.permutations(trio)):
                if va > vc:
                    continue
                for ca in set(map(int, vn[va])) & set(map(int, vn[vb])):
                    for cb in set(map(int, vn[vb])) & set(map(int, vn[vc])):
                        if cb == ca:
                            continue
                        for cc in set(map(int, vn[vc])) & set(
                                map(int, vn[va])):
                            if cc != ca and cc != cb:
                                brute += 1
        assert count_6cycles(code) == brute // 3

    def test_girth8_code_has_zero(self):
        from ldpc_tpu.codes.peg import count_6cycles
        code = qc_peg_construct(kb=12, cb=12, Z=27,
                                col_degrees=[2] * 6 + [3] * 4 + [8] * 2,
                                seed=0)
        assert girth(code) >= 8 and count_6cycles(code) == 0

    def test_seed_selection(self):
        from ldpc_tpu.codes.peg import qc_peg_best
        best, table = qc_peg_best(kb=8, cb=8, Z=16, col_degrees=3,
                                  n_seeds=4, use_absorbing=False)
        counts = {r["seed"]: (r["girth"], r["absorbing"], r["cycles6"])
                  for r in table}
        g, na, c6 = counts[int(best.name.split("-s")[-1])]
        assert all((-g, na, c6) <= (-gg, aa, cc)
                   for gg, aa, cc in counts.values())

    def test_seed_selection_absorbing(self):
        # Round-5: selection key is (girth, c6, exact spectrum) — the
        # silicon-measured ordering (results/census_ab.json +
        # floor_ab.json). At this geometry seed 7 wins on c6 (3888 vs
        # 4536); the exact census (which refutes the round-4 greedy
        # "0-absorbing" score for seed 7 — true total 2691) is the
        # tie-breaker and the floor-estimator feed.
        from ldpc_tpu.codes.peg import qc_peg_best
        best, table = qc_peg_best(kb=12, cb=12, Z=27,
                                  col_degrees=[3] * 9 + [12] * 3,
                                  n_seeds=2, seed0=6)
        by_seed = {r["seed"]: r["absorbing_classes"] for r in table}
        assert by_seed[6].get("(5,2)", 0) == 27
        assert by_seed[7].get("(5,2)", 0) == 0
        assert best.name.endswith("-s7")


class TestCycleCensus8:
    def test_single_8cycle_graph(self):
        from ldpc_tpu.codes.code import LDPCCode
        from ldpc_tpu.codes.peg import count_8cycles
        cn = [np.array([0, 1], np.int32), np.array([1, 2], np.int32),
              np.array([2, 3], np.int32), np.array([0, 3], np.int32)]
        assert count_8cycles(LDPCCode(name="c8", n=4, m=4, k=0,
                                      cn_adj=cn)) == 1

    def test_matches_bruteforce(self):
        import itertools
        from ldpc_tpu.codes.code import LDPCCode
        from ldpc_tpu.codes.peg import count_8cycles
        rng = np.random.default_rng(1)
        cn = [np.sort(rng.choice(10, 3, replace=False)).astype(np.int32)
              for _ in range(7)]
        code = LDPCCode(name="r", n=10, m=7, k=3, cn_adj=cn)
        vn = code.vn_adj()
        brute = 0
        for quad in itertools.permutations(range(10), 4):
            v, w, x, y = quad
            if v != min(quad):
                continue
            for c1 in set(map(int, vn[v])) & set(map(int, vn[w])):
                for c2 in set(map(int, vn[w])) & set(map(int, vn[x])):
                    if c2 == c1:
                        continue
                    for c3 in set(map(int, vn[x])) & set(map(int, vn[y])):
                        if c3 in (c1, c2):
                            continue
                        for c4 in set(map(int, vn[y])) & set(
                                map(int, vn[v])):
                            if c4 in (c1, c2, c3):
                                continue
                            brute += 1
        assert count_8cycles(code) == brute // 2
