"""Multi-device correctness beyond the canonical wifi pipeline.

These tests pin the production paths under a 2x4 ("host","device") mesh on
the 8 virtual CPU devices:

  * the QC-XLA decoder (the DVB-S2/NR regime) through both product seams —
    make_run_batch (sweeps) and make_is_run (IS floors);
  * the shard_map seam that runs the CUDA kernel per device shard
    (sim/pipeline.maybe_shard_map_decoder: the SPMD partitioner would
    otherwise gather and replicate around the opaque foreign call);
  * the fused multi-SNR sweep program under the 2-axis mesh (the
    existing fused invariance test covers only the flat 8-device mesh).

Counter identity across mesh shapes is the repo invariant (CLAUDE.md:
partitionable threefry, fold_in(seed, snr, batch))."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import (CodeConfig, DecoderConfig, QuantConfig,
                             RunConfig, SimConfig)
from ldpc_tpu.parallel import make_mesh
from ldpc_tpu.sim.pipeline import make_run_batch


def _cfg(batch=256, all_zeros=True, **dec_kw):
    dec = dict(algorithm="offset-min-sum", max_iter=5, schedule="layered",
               early_term=False)
    dec.update(dec_kw)
    return SimConfig(code=CodeConfig(family="toy", Z=8),
                     quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
                     decoder=DecoderConfig(**dec),
                     run=RunConfig(batch=batch, seed=3,
                                   all_zeros=all_zeros))


@pytest.mark.slow
def test_qc_backend_mesh_2x4_counter_identity():
    """The QC-XLA decoder through make_run_batch: unsharded == 2x4-mesh
    counters."""
    cfg = _cfg(batch=256)
    from ldpc_tpu.sim.sweep import build_code
    code = build_code(cfg)
    key = jax.random.PRNGKey(7)
    sigma = np.float32(0.8)
    rb1 = make_run_batch(code, cfg, decoder_backend="qc-jnp")
    assert rb1.backend_label == "qc-jnp"
    out1 = tuple(map(int, rb1(key, sigma)))
    mesh = make_mesh(shape=(2, 4), axes=("host", "device"))
    rb8 = make_run_batch(code, cfg, mesh=mesh, decoder_backend="qc-jnp")
    assert rb8.backend_label == "qc-jnp"
    out8 = tuple(map(int, rb8(key, sigma)))
    assert out1 == out8
    assert out1[2] > 0  # frame errors at this sigma: the test is live


@pytest.mark.slow
def test_is_floor_qc_mesh_2x4_counter_identity():
    """Mixture-IS (the DVB floor chain) through the QC-XLA decoder under a
    2x4 mesh: stacked IS sums identical to unsharded — the same identity
    the flat-mesh wifi tests pin (tests/test_trapping.py), for the 2-axis
    mesh."""
    cfg = _cfg(batch=256)
    from ldpc_tpu.sim.impsamp import make_is_run
    from ldpc_tpu.sim.sweep import build_code
    code = build_code(cfg)
    sets = [[0, 3, 9], [1, 4]]
    key = jax.random.PRNGKey(11)
    r1 = make_is_run(code, cfg, sets=sets, delta=1.5, pi0=0.5, batch=256,
                     backend="qc-jnp")
    o1 = np.asarray(r1(key, 0.8))
    mesh = make_mesh(shape=(2, 4), axes=("host", "device"))
    r8 = make_is_run(code, cfg, sets=sets, delta=1.5, pi0=0.5, batch=256,
                     backend="qc-jnp", mesh=mesh)
    o8 = np.asarray(r8(key, 0.8))
    np.testing.assert_allclose(o1, o8, rtol=1e-6)
    assert o1[2] > 0  # raw hits present: the identity is non-vacuous


def test_fused_sweep_mesh_2x4_counter_identity():
    """Fused multi-SNR program under the 2-axis ("host","device") mesh ==
    unsharded, point-for-point (lane->point striping must survive 2-axis
    batch sharding)."""
    cfg = _cfg(batch=192, all_zeros=False)
    from ldpc_tpu.sim.sweep import build_code
    code = build_code(cfg)
    key = jax.random.PRNGKey(5)
    sigmas = jnp.asarray([0.7, 0.9, 1.2], jnp.float32)
    out1 = np.asarray(make_run_batch(code, cfg, decoder_backend="jnp",
                                     n_points=3)(key, sigmas))
    mesh = make_mesh(shape=(2, 4), axes=("host", "device"))
    out8 = np.asarray(make_run_batch(code, cfg, mesh=mesh, n_points=3,
                                     decoder_backend="jnp")(key, sigmas))
    np.testing.assert_array_equal(out1, out8)
    assert out1[2].sum() > 0


@pytest.mark.slow
def test_qc_mesh_flat8_matches_2x4():
    """Mesh-SHAPE invariance for the QC-XLA backend: flat 8 == 2x4
    (counters depend only on the global batch + seed, never the mesh
    factorization)."""
    cfg = _cfg(batch=256)
    from ldpc_tpu.sim.sweep import build_code
    code = build_code(cfg)
    key = jax.random.PRNGKey(7)
    sigma = np.float32(0.8)
    outs = []
    for shape, axes in (((8,), ("batch",)), ((2, 4), ("host", "device"))):
        mesh = make_mesh(shape=shape, axes=axes)
        rb = make_run_batch(code, cfg, mesh=mesh, decoder_backend="qc-jnp")
        assert rb.backend_label == "qc-jnp"
        outs.append(tuple(map(int, rb(key, sigma))))
    assert outs[0] == outs[1]


def test_maybe_shard_map_decoder_guards():
    """The wrapper applies only to the CUDA kernel's label under a mesh,
    preserves batch_tile, and runs the decoder per shard with results
    identical to the unsharded call."""
    from ldpc_tpu.sim.pipeline import maybe_shard_map_decoder
    mesh = make_mesh(shape=(2, 4), axes=("host", "device"))

    def fake_dec(q):
        return q, q[:, 0].astype(jnp.int32), q[:, 1] > 0

    fake_dec.batch_tile = 16
    # other labels: unchanged
    assert maybe_shard_map_decoder(fake_dec, "qc-jnp", mesh) is fake_dec
    # no mesh: unchanged
    assert maybe_shard_map_decoder(fake_dec, "qc-cuda", None) is fake_dec
    w = maybe_shard_map_decoder(fake_dec, "qc-cuda", mesh)
    assert w is not fake_dec and w.batch_tile == 16
    q = jnp.arange(64 * 4, dtype=jnp.int32).reshape(64, 4) % 7 - 3
    for a, b in zip(jax.jit(w)(q), fake_dec(q)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
