"""BER/FER waterfall for the BASELINE.json:11 QAM workload on the GPU:
802.11n n=1944 r=3/4, 16-QAM over complex AWGN, 8-bit OMS layered, per-lane
early termination — the full SDR chain (encode -> Gray map -> AWGN ->
max-log demap -> quantize -> decode -> count) through the round-3
transposed fast path.

Run: PYTHONPATH=. python scripts/make_qam_curve.py [outdir]
"""
import os
import sys
import time

import jax

from ldpc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

sys.path.insert(0, ".")

import dataclasses  # noqa: E402

from ldpc_tpu.config import PRESETS  # noqa: E402
from ldpc_tpu.sim import Sweep  # noqa: E402
from ldpc_tpu.sim.report import plot_waterfall, write_outputs  # noqa: E402


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results"
    os.makedirs(outdir, exist_ok=True)
    cfg = PRESETS["multihost-qam-chain"]
    cfg = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, batch=16384, mesh_shape=None,
                                     seed=1))
    name = "qam16_1944_r34_oms"
    state = os.path.join(outdir, name + ".state")
    t0 = time.time()
    sweep = Sweep(cfg, batch=16384, superbatches=4,
                  checkpoint_path=state)
    res = sweep.run([4.0, 4.5, 5.0, 5.5, 6.0, 6.5],
                    target_frame_errors=200, max_frames=2_000_000)
    res.code_name = name
    write_outputs(res, os.path.join(outdir, name))
    plot_waterfall([res], os.path.join(outdir, name + ".png"),
                   metric="ber",
                   title="802.11n n=1944 r=3/4, 16-QAM AWGN, 8-bit OMS "
                         "layered ET (full chain)")
    print(f"{name}: {time.time()-t0:.0f}s [{res.decoder_backend}]",
          flush=True)


if __name__ == "__main__":
    main()
