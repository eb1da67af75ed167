"""Higher-order modulations and fused sweeps through the batch-first chain.

Layers of evidence:
  * every modulation runs end to end through make_run_batch (encode ->
    modulate -> AWGN -> demap -> quantize -> decode -> count) and decodes a
    noiseless channel without error;
  * dispatch: the BASELINE QAM workload (802.11n n=1944 r=3/4 16-QAM OMS
    layered ET — config.PRESETS['multihost-qam-chain']) resolves to the
    CUDA kernel on a GPU and to the QC-XLA decoder elsewhere;
  * fused multi-SNR (n_points > 1): per-lane sigma, per-point counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.ops import channel as ch


@pytest.mark.parametrize("mod", ch.MODULATIONS)
def test_noiseless_chain_every_modulation(mod):
    """n=180 toy code (a multiple of every symbol size): at negligible noise
    every frame decodes, with zero info-bit errors."""
    from ldpc_tpu.config import (CodeConfig, DecoderConfig, QuantConfig,
                                 RunConfig, SimConfig, ChannelConfig)
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = SimConfig(code=CodeConfig(family="toy", Z=30),
                    channel=ChannelConfig(modulation=mod),
                    quant=QuantConfig(beta_lsb=2),
                    decoder=DecoderConfig(algorithm="offset-min-sum",
                                          schedule="layered", max_iter=4),
                    run=RunConfig(batch=64))
    code = build_code(cfg)
    rb = make_run_batch(code, cfg)
    assert rb.backend_label == "qc-jnp"
    out = np.asarray(rb(jax.random.PRNGKey(1), jnp.float32(1e-3)))
    assert out[0] == 64 and out[1] == 0 and out[2] == 0 and out[4] == 64


def test_awgn_vector_sigma_matches_scalar(rng):
    """A per-lane sigma vector equal everywhere to a scalar gives the same
    noisy symbols (the fused sweep relies on the broadcast)."""
    key = jax.random.PRNGKey(0)
    x = jnp.asarray(rng.standard_normal((6, 40)).astype(np.float32))
    a = np.asarray(ch.awgn(key, x, 0.5))
    b = np.asarray(ch.awgn(key, x, jnp.full((6,), 0.5, jnp.float32)))
    np.testing.assert_array_equal(a, b)


def _qam_cfg(batch, max_iter=20):
    from ldpc_tpu.config import PRESETS
    cfg = PRESETS["multihost-qam-chain"]
    return dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, batch=batch, mesh_shape=None),
        decoder=dataclasses.replace(cfg.decoder, max_iter=max_iter))


def test_qam_workload_dispatch(monkeypatch):
    """The BASELINE QAM workload takes the CUDA kernel on a GPU (its state
    fits an 8-codeword block) and decode_qc on the CPU."""
    from ldpc_tpu.sim import build_code
    from ldpc_tpu.sim.pipeline import select_decoder
    cfg = _qam_cfg(batch=256)
    code = build_code(cfg)
    assert select_decoder(code, cfg)[1] == "qc-jnp"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    dec, label = select_decoder(code, cfg)
    assert label == "qc-cuda" and dec.batch_tile == 8


def test_fused_sweep_per_point_counters():
    """n_points > 1: lane b simulates point b % n_points and the counters
    come back per point."""
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, batch=256),
        decoder=dataclasses.replace(cfg.decoder, max_iter=4))
    code = build_code(cfg)
    rb = make_run_batch(code, cfg, batch=256, n_points=2)
    s0 = ch.sigma_for(2.0, code.rate, "bpsk")
    s1 = ch.sigma_for(4.0, code.rate, "bpsk")
    out = np.asarray(rb(jax.random.PRNGKey(5),
                        jnp.asarray([s0, s1], jnp.float32)))
    assert out.shape == (5, 2) and (out[0] == 128).all()
    # the 4 dB stripe must converge at least as often as the 2 dB stripe
    assert out[4, 1] >= out[4, 0]
    with pytest.raises(ValueError, match="sigma of shape"):
        rb(jax.random.PRNGKey(5), jnp.asarray([s0], jnp.float32))


@pytest.mark.slow
def test_fused_qam_sweep():
    """Fused multi-SNR + 16-QAM: per-lane sigma through the QAM demapper.
    Counters per point, monotone in SNR."""
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = _qam_cfg(batch=256, max_iter=4)
    code = build_code(cfg)
    rb = make_run_batch(code, cfg, batch=256, n_points=2)
    s_lo = ch.sigma_for(4.0, code.rate, "16qam")
    s_hi = ch.sigma_for(8.0, code.rate, "16qam")
    out = np.asarray(rb(jax.random.PRNGKey(2),
                        jnp.asarray([s_lo, s_hi], jnp.float32)))
    assert out.shape == (5, 2) and (out[0] == 128).all()
    assert out[4, 1] >= out[4, 0]  # 8 dB stripe converges at least as often


def test_odd_symbol_size_rejected():
    """A code length that is NOT a multiple of the symbol size (n=1296 with
    32APSK, 5 bits) is refused at build time."""
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(
        cfg,
        code=dataclasses.replace(cfg.code, n=1296),
        channel=dataclasses.replace(cfg.channel, modulation="32apsk"),
        run=dataclasses.replace(cfg.run, batch=128),
        decoder=dataclasses.replace(cfg.decoder, max_iter=2))
    code = build_code(cfg)
    with pytest.raises(ValueError, match="symbol size"):
        make_run_batch(code, cfg, batch=128)
