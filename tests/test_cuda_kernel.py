"""The CUDA decode kernel on the card: bit-exact against golden/decoder.py
and ops/decode_qc.py. Every test here takes the `gpu` fixture, so off the
card they skip; on a GPU machine run them with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import DecoderConfig, QuantConfig, cn_params
from ldpc_tpu.golden.decoder import decode_fixed

pytestmark = pytest.mark.gpu

ALGOS = [("min-sum", 0), ("offset-min-sum", 2), ("normalized-min-sum", 0)]


def _llrs(rng, B, n):
    x = rng.normal(0, 40, size=(B, n))
    x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    return np.clip(np.round(x), -127, 127).astype(np.int8)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("early_term", [False, True])
@pytest.mark.parametrize("algorithm,beta", ALGOS)
@pytest.mark.parametrize("code_fn", [lambda: toy_qc(8),
                                     lambda: make_code(648, "1/2"),
                                     lambda: make_code(1944, "3/4")])
def test_kernel_matches_golden(gpu, rng, code_fn, algorithm, beta, schedule,
                               early_term):
    from ldpc_tpu.kernels import minsum_cuda
    code = code_fn()
    dec = DecoderConfig(algorithm=algorithm, schedule=schedule, max_iter=8,
                        early_term=early_term)
    quant = QuantConfig(beta_lsb=beta)
    chan = _llrs(rng, 20, code.n)  # not a multiple of any tile
    out = tuple(map(np.asarray, jax.jit(
        minsum_cuda.make_decoder(code, dec, quant))(jnp.asarray(chan))))
    b_, alpha = cn_params(dec, quant)
    for i in range(len(chan)):
        g = decode_fixed(chan[i].astype(np.int32), code, max_iter=8,
                         beta=b_, alpha=alpha, qmax=quant.qmax,
                         schedule=schedule, early_term=early_term)
        np.testing.assert_array_equal(out[0][i], g.hard)
        assert out[1][i] == g.iters and out[2][i] == g.converged


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_kernel_matches_qc_decoder(gpu, rng, schedule):
    """A batch of a few thousand codewords: every lane equal to decode_qc."""
    from ldpc_tpu.kernels import minsum_cuda
    from ldpc_tpu.ops.decode_qc import make_decoder as make_qc
    code = make_code(648, "1/2")
    dec = DecoderConfig(algorithm="offset-min-sum", schedule=schedule,
                        max_iter=10, early_term=True)
    quant = QuantConfig(beta_lsb=2)
    chan = jnp.asarray(_llrs(rng, 3000, code.n))
    out = jax.jit(minsum_cuda.make_decoder(code, dec, quant))(chan)
    ref = jax.jit(make_qc(code, dec, quant))(chan)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pipeline_counters_match_qc_jnp(gpu):
    """The full chain through make_run_batch gives identical counters on
    the kernel and on decode_qc (same seed, same batch)."""
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = PRESETS["wifi-648-r12-minsum"]
    code = build_code(cfg)
    sigma = np.float32(sigma_for(2.0, code.rate, "bpsk"))
    outs = []
    for backend in ("qc-cuda", "qc-jnp"):
        rb = make_run_batch(code, cfg, batch=2048, decoder_backend=backend)
        assert rb.backend_label == backend
        outs.append(np.asarray(rb(jax.random.PRNGKey(5), sigma)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_two_phase_on_kernel_is_exact(gpu):
    """Two-phase repacking around the kernel equals single-phase."""
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.sim import build_code, make_run_batch
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, schedule="layered", early_term=True))
    cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, phase1_iters=4, phase2_frac=0.25))
    code = build_code(cfg)
    sigma = np.float32(sigma_for(2.0, code.rate, "bpsk"))
    rb1 = make_run_batch(code, cfg, batch=4096)
    rb2 = make_run_batch(code, cfg2, batch=4096)
    assert rb2.backend_label == "qc-cuda-2phase"
    np.testing.assert_array_equal(np.asarray(rb1(jax.random.PRNGKey(1),
                                                 sigma)),
                                  np.asarray(rb2(jax.random.PRNGKey(1),
                                                 sigma)))
