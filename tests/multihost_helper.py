"""Helper process for the 2-process jax.distributed test (run via
tests/test_multihost.py). Arguments: <coordinator> <num_procs> <proc_id>.

Each process owns 2 local fake CPU devices; the global mesh is
("host", "device") = (num_procs, 2). Prints the psum-reduced counters, which
the parent compares against a single-process run of the same seed — the
mesh-size-invariance contract (SURVEY.md §4.2 'Distributed' row (c))."""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_procs, process_id=pid)
    assert jax.device_count() == 2 * num_procs, jax.devices()
    assert jax.local_device_count() == 2

    from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                                 QuantConfig, RunConfig, SimConfig)
    from ldpc_tpu.parallel import make_mesh
    from ldpc_tpu.sim import build_code, make_run_batch

    cfg = SimConfig(
        code=CodeConfig(family="toy", Z=8),
        channel=ChannelConfig(modulation="bpsk"),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=DecoderConfig(algorithm="min-sum", schedule="flooding",
                              max_iter=6, early_term=True),
        run=RunConfig(batch=32, seed=11),
    )
    code = build_code(cfg)
    mesh = make_mesh(shape=(num_procs, 2), axes=("host", "device"))
    rb = make_run_batch(code, cfg, mesh=mesh, decoder_backend="jnp")
    out = rb(jax.random.PRNGKey(5), np.float32(0.9))
    vals = tuple(int(np.asarray(x)) for x in out)
    print(f"COUNTERS {pid} {vals}", flush=True)


if __name__ == "__main__":
    main()
