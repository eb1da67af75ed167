"""Decoder bit-exactness and the CUDA kernel's wrapper (SURVEY.md §4.2 'Unit:
decoder kernel').

Every decoder must equal the NumPy golden model EXACTLY on identical int8
inputs — min-sum over integers is deterministic, so the contract is
equality, not tolerance.

The CUDA kernel (csrc/minsum_qc.cu) has no CPU mode. What the CPU checks
here is everything around it: the entry table it walks, a NumPy
transcription of its algorithm over that table (int16 posteriors, int8
messages, two-pass check update, flooding as old totals plus message
deltas), the attributes and padding the wrapper hands it, and the tile
choice. The kernel itself is compared with decode_qc and golden on the card
(tests/test_cuda_kernel.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.kernels import minsum_cuda
from ldpc_tpu.ops.decode_qc import make_qc_decoder


def _random_llrs(rng, B, n, qmax=127):
    # Mixture of easy (large-|LLR|) and hard (noisy) lanes to exercise both
    # converged and non-converged paths.
    x = rng.normal(0, 40, size=(B, n))
    x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    return np.clip(np.round(x), -qmax, qmax).astype(np.int8)


def _golden_batch(chan, code, **kw):
    hards, iters, convs = [], [], []
    for row in chan:
        r = decode_fixed(row.astype(np.int32), code, **kw)
        hards.append(r.hard)
        iters.append(r.iters)
        convs.append(r.converged)
    return np.stack(hards), np.array(iters), np.array(convs)


def emulate_kernel(chan, table, Z, mb, max_iter, qmax, beta, alpha,
                   flooding, early_term):
    """NumPy transcription of csrc/minsum_qc.cu over the wrapper's table:
    state laid out (variable, lane) as in shared memory, int16 posteriors,
    int8 messages. The kernel's per-block exit is per batch here; frozen
    lanes make the two identical."""
    B, n = chan.shape
    off = table[:mb + 1]
    E = int(off[-1])
    col_z = table[mb + 1:mb + 1 + E]
    shift = table[mb + 1 + E:]
    z = np.arange(Z)
    var = [col_z[e] + (z + shift[e]) % Z for e in range(E)]  # (Z,) each
    tot = chan.T.astype(np.int16)
    c2v = np.zeros((E, Z, B), np.int8)

    def unsat(post):
        bad = np.zeros(B, bool)
        for L in range(mb):
            par = np.zeros((Z, B), bool)
            for e in range(off[L], off[L + 1]):
                par ^= post[var[e]] < 0
            bad |= par.any(axis=0)
        return bad

    done = ~unsat(tot) if early_term else np.zeros(B, bool)
    iters = np.zeros(B, np.int32)
    for _ in range(max_iter):
        if early_term and done.all():
            break
        act = ~done
        nxt = tot.copy() if flooding else tot
        for L in range(mb):
            es = range(off[L], off[L + 1])
            raw = {e: tot[var[e]].astype(np.int32) - c2v[e] for e in es}
            x = {e: np.clip(raw[e], -qmax, qmax) for e in es}
            min1 = np.full((Z, B), 1 << 14)
            min2 = min1.copy()
            sgn = np.zeros((Z, B), np.int32)
            for e in es:
                m = np.abs(x[e])
                min2 = np.minimum(min2, np.maximum(min1, m))
                min1 = np.minimum(min1, m)
                sgn ^= x[e]
            o1, o2 = min1, min2
            if alpha is not None:
                o1 = (o1 * alpha[0]) >> alpha[1]
                o2 = (o2 * alpha[0]) >> alpha[1]
            if beta:
                o1 = np.maximum(o1 - beta, 0)
                o2 = np.maximum(o2 - beta, 0)
            for e in es:
                mag = np.where(np.abs(x[e]) == min1, o2, o1)
                nw = np.where((sgn ^ x[e]) < 0, -mag, mag)
                old = c2v[e].astype(np.int32)
                c2v[e] = np.where(act, nw, old)
                if flooding:
                    nxt[var[e]] += np.where(act, nw - old, 0).astype(np.int16)
                else:
                    tot[var[e]] = np.where(act, raw[e] + nw, tot[var[e]])
        iters += act
        tot = nxt
        if early_term:
            done |= ~unsat(tot)
    conv = done if early_term else ~unsat(tot)
    return (tot.T < 0).astype(np.uint8), iters, conv


CASES = [
    dict(schedule="flooding", beta=0, early_term=False, max_iter=6),
    dict(schedule="flooding", beta=0, early_term=True, max_iter=7),
    dict(schedule="flooding", beta=2, early_term=True, max_iter=6),
    dict(schedule="layered", beta=0, early_term=False, max_iter=6),
    dict(schedule="layered", beta=2, early_term=True, max_iter=7),
]


@pytest.mark.parametrize("kw", CASES)
def test_toy_qc_bitexact(rng, kw):
    code = toy_qc(Z=4)
    B = 8
    chan = _random_llrs(rng, B, code.n)
    dec = make_qc_decoder(code, qmax=127, **kw)
    hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan)))
    g_hard, g_iters, g_conv = _golden_batch(chan, code, qmax=127, **kw)
    np.testing.assert_array_equal(hard, g_hard)
    np.testing.assert_array_equal(iters, g_iters)
    np.testing.assert_array_equal(conv, g_conv)


@pytest.mark.parametrize("kw", CASES + [
    dict(schedule="layered", beta=0, early_term=True, max_iter=6,
         alpha=(3, 2)),
])
def test_kernel_transcription_bitexact(rng, kw):
    """The kernel's algorithm over the table the wrapper builds equals
    golden: catches a wrong table encoding, shift direction or update
    order before the code reaches the card."""
    code = toy_qc(Z=8)
    chan = _random_llrs(rng, 16, code.n)
    kw = dict(kw)
    alpha = kw.pop("alpha", None)
    table = minsum_cuda.layer_table(code)
    hard, iters, conv = emulate_kernel(
        chan, table, code.Z, code.base.shape[0], kw["max_iter"], 127,
        kw["beta"], alpha, kw["schedule"] == "flooding", kw["early_term"])
    g_hard, g_iters, g_conv = _golden_batch(chan, code, qmax=127,
                                            alpha=alpha, **kw)
    np.testing.assert_array_equal(hard, g_hard)
    np.testing.assert_array_equal(iters, g_iters)
    np.testing.assert_array_equal(conv, g_conv)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_random_topology_bitexact(seed, rng):
    """Topology fuzz: randomly GENERATED small QC codes (random row
    supports, random shifts via gen_qc_code — different kb/cb/extension
    shapes per seed) must decode bit-exactly vs golden through the QC
    decoder and the kernel transcription, both schedules. Guards the layout
    compiler against assumptions that happen to hold for the standard code
    shapes."""
    from ldpc_tpu.codes.qcstruct import gen_qc_code
    g = np.random.default_rng(seed)
    kb = int(g.integers(3, 7))
    cb = int(g.integers(3, 5))
    mb = cb + int(g.integers(0, 3))  # 0-2 extension rows
    Z = int(g.choice([4, 6, 8]))
    rows = []
    for i in range(mb):
        deg = int(g.integers(2, kb + 1))
        rows.append(sorted(g.choice(kb, size=deg, replace=False).tolist()))
    ext_core = [sorted((kb + g.choice(cb, size=int(g.integers(1, 3)),
                                      replace=False)).tolist())
                for _ in range(mb - cb)]
    code = gen_qc_code(rows, kb=kb, cb=cb, Z=Z, rng=g,
                       name=f"fuzz_{seed}",
                       ext_core_cols=ext_core if mb > cb else None,
                       require_girth6=False)
    B = 8
    chan = _random_llrs(rng, B, code.n)
    table = minsum_cuda.layer_table(code)
    for kw in (dict(schedule="flooding", beta=2, early_term=True,
                    max_iter=5),
               dict(schedule="layered", beta=0, early_term=True,
                    max_iter=5)):
        g_hard, g_iters, g_conv = _golden_batch(chan, code, qmax=127, **kw)
        dec = make_qc_decoder(code, qmax=127, **kw)
        outs = (tuple(map(np.asarray, dec(jnp.asarray(chan)))),
                emulate_kernel(chan, table, Z, code.base.shape[0],
                               kw["max_iter"], 127, kw["beta"], None,
                               kw["schedule"] == "flooding", True))
        for hard, iters, conv in outs:
            np.testing.assert_array_equal(hard, g_hard)
            np.testing.assert_array_equal(iters, g_iters)
            np.testing.assert_array_equal(conv, g_conv)


@pytest.mark.parametrize("kw", [
    dict(schedule="flooding", beta=0, early_term=False, max_iter=5),
    dict(schedule="layered", beta=2, early_term=True, max_iter=5),
])
@pytest.mark.slow
def test_wifi648_bitexact(rng, kw):
    code = make_code(648, "1/2")
    B = 4
    chan = _random_llrs(rng, B, code.n)
    dec = make_qc_decoder(code, qmax=127, **kw)
    hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan)))
    g_hard, g_iters, g_conv = _golden_batch(chan, code, qmax=127, **kw)
    np.testing.assert_array_equal(hard, g_hard)
    np.testing.assert_array_equal(iters, g_iters)
    np.testing.assert_array_equal(conv, g_conv)


@pytest.mark.slow
@pytest.mark.parametrize("bits", [4, 6])
def test_low_bitwidth_bitexact(rng, bits):
    """Bit widths below the canonical 8 (the reference class exists to study
    exactly this): the QC decoder and the kernel transcription must stay
    bit-exact vs golden at qmax = 2**(bits-1) - 1. Messages/posteriors only
    shrink, so every storage path (int8 c2v, int16 totals) stays lossless."""
    qmax = (1 << (bits - 1)) - 1
    code = toy_qc(Z=4)
    B = 8
    chan = _random_llrs(rng, B, code.n, qmax=qmax)
    table = minsum_cuda.layer_table(code)
    for kw in (dict(schedule="flooding", beta=1, early_term=True, max_iter=6),
               dict(schedule="layered", beta=0, early_term=True, max_iter=6)):
        g_hard, g_iters, g_conv = _golden_batch(chan, code, qmax=qmax, **kw)
        qdec = make_qc_decoder(code, qmax=qmax, **kw)
        outs = (tuple(map(np.asarray, qdec(jnp.asarray(chan)))),
                emulate_kernel(chan, table, 4, code.base.shape[0],
                               kw["max_iter"], qmax, kw["beta"], None,
                               kw["schedule"] == "flooding", True))
        for hard, iters, conv in outs:
            np.testing.assert_array_equal(hard, g_hard)
            np.testing.assert_array_equal(iters, g_iters)
            np.testing.assert_array_equal(conv, g_conv)


def test_all_zero_noiseless(rng):
    """All-zeros codeword with clean LLRs converges instantly with 0 iters."""
    code = toy_qc(Z=4)
    chan = np.full((4, code.n), 60, np.int8)
    dec = make_qc_decoder(code, schedule="layered", early_term=True,
                          max_iter=5)
    hard, iters, conv = map(np.asarray, dec(jnp.asarray(chan)))
    assert not hard.any()
    assert (iters == 0).all()
    assert conv.all()


@pytest.mark.slow
def test_c2v_dtypes(rng):
    """int16/int8 c2v STORAGE must not change results (values are clipped to
    +-qmax before storing, so narrower storage is lossless)."""
    code = toy_qc(Z=4)
    chan = jnp.asarray(_random_llrs(rng, 64, code.n))
    outs = []
    for dt in (jnp.int32, jnp.int16, jnp.int8):
        dec = make_qc_decoder(code, qmax=127, schedule="flooding",
                              early_term=False, max_iter=4, c2v_dtype=dt)
        outs.append(tuple(map(np.asarray, dec(chan))))
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            np.testing.assert_array_equal(a, b)


class TestCudaWrapper:
    """What minsum_cuda hands the kernel, checked by routing the foreign
    call to the NumPy transcription above."""

    @staticmethod
    def _fake_ffi(monkeypatch, seen):
        monkeypatch.setattr(minsum_cuda, "_register", lambda: None)

        def ffi_call(target, result_shapes):
            assert target == minsum_cuda._TARGET

            def call(q, table, **attrs):
                seen.append((q.shape, attrs))
                assert q.shape[0] % int(attrs["tile"]) == 0

                def host(q, table):
                    h, it, cv = emulate_kernel(
                        np.asarray(q), np.asarray(table), int(attrs["Z"]),
                        int(attrs["mb"]), int(attrs["max_iter"]),
                        int(attrs["qmax"]), int(attrs["beta"]),
                        None if attrs["alpha_shift"] < 0 else
                        (int(attrs["alpha_num"]), int(attrs["alpha_shift"])),
                        bool(attrs["flooding"]), bool(attrs["early_term"]))
                    return h, it, cv.astype(np.uint8)
                return jax.pure_callback(host, result_shapes, q, table)
            return call
        monkeypatch.setattr(jax.ffi, "ffi_call", ffi_call)

    @pytest.mark.parametrize("algorithm,schedule,et", [
        ("min-sum", "flooding", False),
        ("offset-min-sum", "layered", True),
        ("normalized-min-sum", "flooding", True),
    ])
    def test_pads_to_tile_and_matches_qc(self, monkeypatch, rng, algorithm,
                                         schedule, et):
        from ldpc_tpu.config import DecoderConfig, QuantConfig
        from ldpc_tpu.ops.decode_qc import make_decoder as make_qc
        seen = []
        self._fake_ffi(monkeypatch, seen)
        code = toy_qc(Z=8)
        dec_cfg = DecoderConfig(algorithm=algorithm, schedule=schedule,
                                max_iter=6, early_term=et)
        quant = QuantConfig(beta_lsb=2)
        dec = minsum_cuda.make_decoder(code, dec_cfg, quant)
        B = dec.batch_tile + 5  # not a multiple of the tile
        chan = jnp.asarray(_random_llrs(rng, B, code.n))
        out = tuple(map(np.asarray, jax.jit(dec)(chan)))
        ref = tuple(map(np.asarray, make_qc(code, dec_cfg, quant)(chan)))
        (shape, attrs), = seen
        assert shape == (2 * dec.batch_tile, code.n)
        assert out[0].shape == (B, code.n) and out[2].dtype == bool
        assert int(attrs["zslots"]) == minsum_cuda.zslots(code.Z,
                                                          dec.batch_tile)
        assert int(attrs["n_entries"]) == int((code.base >= 0).sum())
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)

    def test_rejects_outside_domain(self):
        from ldpc_tpu.config import DecoderConfig, PRESETS, QuantConfig
        from ldpc_tpu.sim import build_code
        code = toy_qc(Z=4)
        with pytest.raises(ValueError, match="domain"):
            minsum_cuda.make_decoder(
                code, DecoderConfig(algorithm="min-star"), QuantConfig())
        dvb = PRESETS["dvbs2-64800-r12"]
        with pytest.raises(ValueError, match="domain"):
            minsum_cuda.make_decoder(build_code(dvb), dvb.decoder, dvb.quant)


@pytest.mark.parametrize("n,rate,schedule,tile", [
    (648, "1/2", "flooding", 16),
    (648, "1/2", "layered", 16),
    (1944, "3/4", "layered", 8),
    (1944, "1/2", "flooding", 8),
])
def test_pick_tile(n, rate, schedule, tile):
    """The widest tile with which two blocks share an SM (two blocks hide
    each other's barrier waits), else the widest that fits one block."""
    code = make_code(n, rate)
    assert minsum_cuda.pick_tile(code, schedule) == tile
    used = minsum_cuda.smem_bytes(code, tile, schedule)
    assert used <= minsum_cuda.SMEM_LIMIT
    # the per-codeword state the footprint is built from
    per_cw = (n * 2 * (2 if schedule == "flooding" else 1)
              + int((code.base >= 0).sum()) * code.Z)
    assert tile * per_cw <= used < tile * per_cw + 4096


def test_fits_by_state_size_and_algorithm():
    from ldpc_tpu.config import DecoderConfig, PRESETS, QuantConfig
    from ldpc_tpu.sim import build_code
    wifi = make_code(648, "1/2")
    assert minsum_cuda.fits(wifi, DecoderConfig(), QuantConfig())
    assert not minsum_cuda.fits(wifi, DecoderConfig(algorithm="min-star"),
                                QuantConfig())
    for name in ("dvbs2-64800-r12", "nr-bg1-layered"):
        cfg = PRESETS[name]
        assert not minsum_cuda.fits(build_code(cfg), cfg.decoder, cfg.quant)


@pytest.mark.parametrize("Z,tile", [(27, 16), (81, 8), (54, 32), (8, 16)])
def test_zslots_divides_z(Z, tile):
    zs = minsum_cuda.zslots(Z, tile)
    assert Z % zs == 0 and zs * tile <= minsum_cuda.MAX_THREADS


class TestTwoPhaseET:
    """Two-phase repacking early termination (pipeline.make_two_phase_decoder)
    must be BIT-EXACT vs the single-phase ET decoder: integer min-sum is
    deterministic, so restarting an unconverged lane replays its trajectory."""

    def _cfg(self, p1):
        from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                                     QuantConfig, RunConfig, SimConfig)
        return SimConfig(
            code=CodeConfig(family="toy", Z=8),
            channel=ChannelConfig(),
            quant=QuantConfig(bits=8, scale=4.0, beta_lsb=0),
            decoder=DecoderConfig(algorithm="min-sum", schedule="flooding",
                                  max_iter=12, early_term=True,
                                  phase1_iters=p1),
            run=RunConfig(batch=256))

    def test_bitexact_vs_single_phase(self, rng):
        import dataclasses
        from ldpc_tpu.sim.pipeline import select_decoder
        code = toy_qc(8)
        B = 256
        # channel-realistic LLRs at a sigma where ~10% of lanes miss the
        # phase-1 budget (tuned: sigma=0.8 -> ~40/256 unconverged at 12 it)
        sigma = 0.8
        y = 1.0 + sigma * rng.standard_normal((B, code.n))
        chan = np.clip(np.round(2 * y / sigma**2 * 4.0),
                       -127, 127).astype(np.int8)
        cfg2 = self._cfg(3)
        cfg1 = dataclasses.replace(
            cfg2, decoder=dataclasses.replace(cfg2.decoder,
                                              phase1_iters=None))
        d2, lbl2 = select_decoder(code, cfg2, "jnp", batch=B)
        d1, lbl1 = select_decoder(code, cfg1, "jnp", batch=B)
        assert lbl2.endswith("-2phase") and not lbl1.endswith("-2phase")
        h2, it2, cv2 = map(np.asarray, d2(chan))
        h1, it1, cv1 = map(np.asarray, d1(chan))
        assert 0 < (~cv1).sum() <= B // 4, "operating point off for the test"
        np.testing.assert_array_equal(h2, h1)
        np.testing.assert_array_equal(it2, it1)
        np.testing.assert_array_equal(cv2, cv1)

    def test_overflow_falls_back_exactly(self, rng):
        """More unconverged lanes than capacity -> full-batch fallback, same
        results."""
        import dataclasses
        from ldpc_tpu.sim.pipeline import select_decoder
        code = toy_qc(8)
        B = 256
        chan = (rng.integers(-6, 6, size=(B, code.n))).astype(np.int8)  # junk
        # junk LLRs: nearly nothing converges -> capacity overflow
        cfg2 = self._cfg(2)
        cfg1 = dataclasses.replace(
            cfg2, decoder=dataclasses.replace(cfg2.decoder,
                                              phase1_iters=None))
        d2, _ = select_decoder(code, cfg2, "jnp", batch=B)
        d1, _ = select_decoder(code, cfg1, "jnp", batch=B)
        h2, it2, cv2 = map(np.asarray, d2(chan))
        h1, it1, cv1 = map(np.asarray, d1(chan))
        assert (~cv1).sum() > B // 4  # genuinely overflows capacity
        np.testing.assert_array_equal(h2, h1)
        np.testing.assert_array_equal(it2, it1)
        np.testing.assert_array_equal(cv2, cv1)
