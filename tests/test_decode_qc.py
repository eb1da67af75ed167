"""QC-structured jnp decoder (ops/decode_qc.py): bit-exact vs the C oracle
(itself golden-exact) — the decode path for codes whose state exceeds a GPU
thread block (SURVEY.md §5.7) and the reference for the CUDA kernel — and
the dispatch that chooses between the two."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu import oracle
from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.ops.decode_qc import make_qc_decoder


def _llrs(rng, B, n):
    x = rng.normal(0, 40, size=(B, n))
    x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    return np.clip(np.round(x), -127, 127).astype(np.int8)


@pytest.mark.parametrize("kw", [
    dict(schedule="flooding", beta=0, early_term=False, max_iter=6),
    dict(schedule="flooding", beta=2, early_term=True, max_iter=7),
    dict(schedule="layered", beta=0, early_term=True, max_iter=6),
    dict(schedule="layered", beta=2, early_term=False, max_iter=5),
])
@pytest.mark.parametrize("code_fn", [
    lambda: toy_qc(4),
    pytest.param(lambda: make_code(648, "1/2"), marks=pytest.mark.slow),
])
def test_qc_decoder_bitexact(code_fn, kw, rng):
    code = code_fn()
    B = 32
    chan = _llrs(rng, B, code.n)
    dec = jax.jit(make_qc_decoder(code, qmax=127, **kw))
    h, it, cv = map(np.asarray, dec(chan))
    ho, ito, cvo = oracle.decode_batch(chan, code, qmax=127, **kw)
    np.testing.assert_array_equal(h, ho)
    np.testing.assert_array_equal(it, ito)
    np.testing.assert_array_equal(cv, cvo)


def test_auto_selection_large_code_uses_qc_jnp(monkeypatch):
    """DVB-S2 state exceeds a thread block -> auto backend resolves to qc-jnp
    even on a GPU; the small canonical code takes the CUDA kernel."""
    import ldpc_tpu.sim.pipeline as pl
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import build_code
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    import dataclasses
    cfg = PRESETS["dvbs2-64800-r12"]
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, schedule="flooding", early_term=True))
    code = build_code(cfg)
    _, backend = pl.select_decoder(code, cfg)
    assert backend == "qc-jnp"
    cfg2 = PRESETS["wifi-648-r12-minsum"]
    _, backend2 = pl.select_decoder(build_code(cfg2), cfg2)
    assert backend2 == "qc-cuda"


class TestAutoDispatch:
    """Where auto sends each large-code regime: QC codes too large for a
    thread block go to decode_qc on any platform, and off the GPU every QC
    code does."""

    def test_auto_dispatch_dvbs2_fixed_iterations(self, monkeypatch):
        import ldpc_tpu.sim.pipeline as pl_mod
        from ldpc_tpu.config import PRESETS
        from ldpc_tpu.sim import build_code
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        cfg = PRESETS["dvbs2-64800-r12"]
        _, backend = pl_mod.select_decoder(build_code(cfg), cfg)
        assert backend == "qc-jnp"

    def test_et_dispatch_by_state_size(self, monkeypatch):
        import dataclasses
        import ldpc_tpu.sim.pipeline as pl_mod
        from ldpc_tpu.config import PRESETS
        from ldpc_tpu.sim import build_code
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        cfg = PRESETS["dvbs2-64800-r12"]
        cfg = dataclasses.replace(
            cfg, decoder=dataclasses.replace(cfg.decoder, early_term=True))
        for n in (64800, 16200):
            c = dataclasses.replace(
                cfg, code=dataclasses.replace(cfg.code, n=n))
            _, backend = pl_mod.select_decoder(build_code(c), c)
            assert backend == "qc-jnp", n
        qam = PRESETS["multihost-qam-chain"]  # n=1944 layered OMS ET
        dec, backend = pl_mod.select_decoder(build_code(qam), qam)
        assert backend == "qc-cuda" and dec.batch_tile == 8

    def test_cpu_auto_is_qc_jnp(self):
        import ldpc_tpu.sim.pipeline as pl_mod
        from ldpc_tpu.config import PRESETS
        from ldpc_tpu.sim import build_code
        cfg = PRESETS["wifi-648-r12-minsum"]
        _, backend = pl_mod.select_decoder(build_code(cfg), cfg)
        assert backend == "qc-jnp"
        with pytest.raises(ValueError, match="only on a GPU"):
            pl_mod.select_decoder(build_code(cfg), cfg, "qc-cuda")


@pytest.mark.parametrize("kw", [
    dict(schedule="layered", beta=2, early_term=True, max_iter=4),
    dict(schedule="layered", beta=2, early_term=False, max_iter=5),
])
def test_odd_mb_bitexact(kw, rng):
    """Odd base-row counts (DVB-S2 n=16200 has mb=25) through decode_qc:
    a small odd-mb toy keeps the oracle comparison fast."""
    from ldpc_tpu.codes.toy import toy_qc_odd
    code = toy_qc_odd(16)
    x = rng.normal(20, 14, size=(64, code.n))
    chan = np.clip(np.round(x), -127, 127).astype(np.int8)
    dec = jax.jit(make_qc_decoder(code, qmax=127, **kw))
    h, it, cv = map(np.asarray, dec(chan))
    ho, ito, cvo = oracle.decode_batch(chan, code, qmax=127, **kw)
    np.testing.assert_array_equal(h, ho)
    np.testing.assert_array_equal(it, ito)
    np.testing.assert_array_equal(cv, cvo)


def test_degree1_base_row_rejected():
    """A degree-1 base row would leave min2 at the 1<<14 sentinel and emit
    c2v = +-(1<<14 - beta) truncated through int8 — both QC decoders refuse
    it up front instead of silently mis-decoding."""
    from ldpc_tpu.codes.code import expand_qc
    from ldpc_tpu.config import DecoderConfig, QuantConfig
    from ldpc_tpu.kernels import minsum_cuda

    base = np.array([[0, 1, -1, 0], [-1, -1, 2, -1]], np.int64)  # row 1: deg 1
    code = expand_qc(base, 8, name="deg1_toy", standard_exact=False)
    with pytest.raises(ValueError, match="degree-1"):
        make_qc_decoder(code, max_iter=4)
    with pytest.raises(ValueError, match="degree-1"):
        minsum_cuda.make_decoder(code, DecoderConfig(max_iter=4),
                                 QuantConfig())


def test_backend_label_roundtrip_idempotent(monkeypatch):
    """Sweep resolves the backend once and feeds the emitted LABEL back into
    make_run_batch; select_decoder must accept its own labels (a label that
    fell through to the dense jnp decoder once silently bypassed the fast
    path for every CLI sweep)."""
    import dataclasses
    import ldpc_tpu.sim.pipeline as pl
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import build_code
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = PRESETS["dvbs2-64800-r12"]
    code = build_code(cfg)
    _, label = pl.select_decoder(code, cfg, "auto")
    assert label == "qc-jnp"
    _, label2 = pl.select_decoder(code, cfg, label)
    assert label2 == label
    # two-phase labels strip their suffix and re-derive the wrapper
    cfg2 = PRESETS["wifi-648-r12-minsum"]
    cfg2 = dataclasses.replace(cfg2, decoder=dataclasses.replace(
        cfg2.decoder, early_term=True, phase1_iters=4))
    code2 = build_code(cfg2)
    _, lab = pl.select_decoder(code2, cfg2, "auto", batch=1024)
    assert lab == "qc-cuda-2phase"
    _, lab2 = pl.select_decoder(code2, cfg2, lab, batch=1024)
    assert lab2 == lab
    with pytest.raises(ValueError, match="unknown decoder backend"):
        pl.select_decoder(code2, cfg2, "pallas")


def test_two_phase_capacity_respects_stream_tile(monkeypatch):
    """Two-phase capacity must round up to the decoder's codeword tile — a
    partial tile would decode padding lanes. The CUDA kernel's tile is 16
    on 802.11n n=648."""
    import dataclasses
    import ldpc_tpu.sim.pipeline as pl
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import build_code
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(
            cfg.decoder, schedule="layered", early_term=True,
            phase1_iters=4, phase2_frac=0.1))
    code = build_code(cfg)
    dec, label = pl.select_decoder(code, cfg, "auto", batch=2048)
    assert label == "qc-cuda-2phase" and dec.batch_tile == 16
    # 0.1 * 2048 = 204.8 -> must round UP to a multiple of 16
    assert dec.capacity % 16 == 0 and dec.capacity >= 205
