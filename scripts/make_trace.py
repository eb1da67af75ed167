"""Produce a profiler trace artifact of the hot decode kernel.

Demonstrates the tracing subsystem (SURVEY.md §5.1, utils/profiling.trace):
wraps a few canonical-config pipeline batches in jax.profiler.trace and
writes a TensorBoard/Perfetto trace directory. On the GPU the trace
contains per-kernel device timelines (the CUDA min-sum kernel shows up
under its symbol, minsum_qc_kernel); on CPU it still records the XLA host
execution.

Usage:
  python scripts/make_trace.py [outdir]        # default results/trace
View: tensorboard --logdir <outdir>  (profile plugin), or load the
.perfetto-trace file in ui.perfetto.dev.
"""
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results/trace"
    import jax
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.sim import build_code, make_run_batch
    from ldpc_tpu.utils.profiling import trace

    cfg = PRESETS["wifi-648-r12-minsum"]
    code = build_code(cfg)
    batch = 16384
    rb = make_run_batch(code, cfg, batch=batch, decoder_backend="auto")
    sigma = np.float32(sigma_for(cfg.channel.ebn0_db, code.rate, "bpsk"))
    key = jax.random.PRNGKey(0)
    np.asarray(rb(key, sigma))  # compile outside the trace
    with trace(outdir):
        for i in range(3):
            out = rb(jax.random.fold_in(key, i), sigma)
        np.asarray(out)  # fetch-sync inside the trace window
    print(f"wrote trace to {outdir} (platform={jax.default_backend()})")


if __name__ == "__main__":
    main()
