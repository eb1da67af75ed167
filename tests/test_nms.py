"""Normalized min-sum (alpha-scaled) — bit-exact equality across every
decoder implementation, with the golden model as the source of truth.

The CN magnitude transform is pinned by config.QuantConfig:
mag' = max(((mag * alpha_num) >> alpha_shift) - beta, 0); cn_params() maps
algorithm -> (beta, alpha) once for all backends.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu import oracle
from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import DecoderConfig, QuantConfig, cn_params
from ldpc_tpu.golden.decoder import decode_fixed

ALPHA = (3, 2)  # 0.75


def test_cn_params_mapping():
    q = QuantConfig(beta_lsb=2, alpha_num=3, alpha_shift=2)
    assert cn_params(DecoderConfig(algorithm="min-sum"), q) == (0, None)
    assert cn_params(DecoderConfig(algorithm="offset-min-sum"), q) == (2, None)
    assert cn_params(DecoderConfig(algorithm="normalized-min-sum"),
                     q) == (0, (3, 2))
    # alpha = 1 degenerates to plain min-sum
    q1 = QuantConfig(alpha_num=1, alpha_shift=0)
    assert cn_params(DecoderConfig(algorithm="normalized-min-sum"),
                     q1) == (0, None)
    with pytest.raises(ValueError, match="alpha"):
        cn_params(DecoderConfig(algorithm="normalized-min-sum"),
                  QuantConfig(alpha_num=5, alpha_shift=2))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_jnp_matches_golden(rng, schedule):
    from ldpc_tpu.ops.decode_ref import (make_flooding_decoder,
                                         make_layered_decoder)
    code = toy_qc(8)
    B = 48
    chan = rng.integers(-40, 40, size=(B, code.n)).astype(np.int8)
    maker = (make_layered_decoder if schedule == "layered"
             else make_flooding_decoder)
    dec = maker(code, max_iter=5, beta=0, qmax=127, early_term=True,
                alpha=ALPHA)
    h, it, cv = map(np.asarray, dec(jnp.asarray(chan)))
    for b in range(B):
        g = decode_fixed(chan[b], code, max_iter=5, beta=0, qmax=127,
                         schedule=schedule, early_term=True, alpha=ALPHA)
        np.testing.assert_array_equal(g.hard, h[b])
        assert (g.iters, g.converged) == (int(it[b]), bool(cv[b])), b


@pytest.mark.slow
def test_qc_and_oracle_match_golden(rng):
    from ldpc_tpu.ops.decode_qc import make_qc_decoder
    code = make_code(648, "1/2")
    B = 16
    chan = rng.integers(-40, 40, size=(B, code.n)).astype(np.int8)
    dec = make_qc_decoder(code, max_iter=4, beta=0, qmax=127,
                          schedule="layered", early_term=False, alpha=ALPHA)
    h, it, cv = map(np.asarray, dec(jnp.asarray(chan)))
    ho, ito, cvo = oracle.decode_batch(chan, code, max_iter=4, beta=0,
                                       qmax=127, schedule="layered",
                                       early_term=False, alpha=ALPHA)
    np.testing.assert_array_equal(h, ho)
    np.testing.assert_array_equal(cv, cvo)
    g = decode_fixed(chan[0], code, max_iter=4, beta=0, qmax=127,
                     schedule="layered", early_term=False, alpha=ALPHA)
    np.testing.assert_array_equal(g.hard, h[0])


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_qc_et_matches_golden(rng, schedule):
    """NMS with early termination through decode_qc (the reference the CUDA
    kernel is compared with on the card) against golden, lane by lane."""
    from ldpc_tpu.ops.decode_qc import make_qc_decoder
    code = toy_qc(8)
    B = 128
    chan = rng.integers(-40, 40, size=(B, code.n)).astype(np.int8)
    dec = make_qc_decoder(code, max_iter=4, beta=0, qmax=127,
                          schedule=schedule, early_term=True, alpha=ALPHA)
    h, it, cv = map(np.asarray, dec(jnp.asarray(chan)))
    for b in range(12):
        g = decode_fixed(chan[b], code, max_iter=4, beta=0, qmax=127,
                         schedule=schedule, early_term=True, alpha=ALPHA)
        np.testing.assert_array_equal(g.hard, h[b])
        assert (g.iters, g.converged) == (int(it[b]), bool(cv[b])), b


def test_nms_beats_minsum_ber(rng):
    """The point of NMS: at the same iteration budget it corrects the
    min-sum overestimate. Cheap statistical check on the toy code."""
    import jax

    from ldpc_tpu.config import PRESETS, SimConfig
    from ldpc_tpu.sim import Sweep

    base = PRESETS["wifi-648-r12-minsum"]
    errs = {}
    for alg in ("min-sum", "normalized-min-sum"):
        cfg = dataclasses.replace(
            base,
            decoder=dataclasses.replace(base.decoder, algorithm=alg,
                                        max_iter=10),
            run=dataclasses.replace(base.run, batch=512, max_frames=1024,
                                    target_frame_errors=10 ** 9, seed=7),
        )
        res = Sweep(cfg).run([2.0])
        errs[alg] = res.rows()[0]["bit_errs"]
    assert errs["normalized-min-sum"] < errs["min-sum"]
