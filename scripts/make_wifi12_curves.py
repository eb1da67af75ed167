"""BER/FER curves for ALL 12 IEEE 802.11n codes on the GPU.

One sweep per (n, rate) — n in {648, 1296, 1944} x rate in {1/2, 2/3, 3/4,
5/6} — 8-bit OMS, layered, early termination, BPSK/AWGN, per-rate Eb/N0
grids. Writes results/wifi12_{n}_{rate}.{json,csv} and a combined 12-curve
plot results/wifi12_ber.png (SURVEY.md §2.1 C2: the reference's full
802.11n code set, exercised end-to-end).

Run: PYTHONPATH=. python scripts/make_wifi12_curves.py [outdir]
"""
import os
import sys
import time

sys.path.insert(0, ".")

import jax

from ldpc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                             QuantConfig, RunConfig, SimConfig)
from ldpc_tpu.sim import Sweep
from ldpc_tpu.sim.report import plot_waterfall, write_outputs

GRIDS = {
    "1/2": [1.0, 1.5, 2.0, 2.5, 3.0],
    "2/3": [1.5, 2.0, 2.5, 3.0, 3.5],
    "3/4": [2.0, 2.5, 3.0, 3.5, 4.0],
    "5/6": [2.5, 3.0, 3.5, 4.0, 4.5],
}


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results"
    os.makedirs(outdir, exist_ok=True)
    results = []
    for n in (648, 1296, 1944):
        for rate, grid in GRIDS.items():
            name = f"wifi12_{n}_r{rate.replace('/', '')}"
            cfg = SimConfig(
                code=CodeConfig(family="ieee80211n", n=n, rate=rate),
                channel=ChannelConfig(modulation="bpsk"),
                quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
                decoder=DecoderConfig(algorithm="offset-min-sum",
                                      schedule="layered", max_iter=20,
                                      early_term=True),
                run=RunConfig(seed=1))
            t0 = time.time()
            sweep = Sweep(cfg, batch=8192, superbatches=4,
                          checkpoint_path=os.path.join(outdir,
                                                       name + ".state"))
            res = sweep.run(grid, target_frame_errors=200,
                            max_frames=400_000)
            res.code_name = name
            write_outputs(res, os.path.join(outdir, name))
            results.append(res)
            print(f"{name}: {time.time()-t0:.0f}s [{res.decoder_backend}]",
                  flush=True)
    plot_waterfall(results, os.path.join(outdir, "wifi12_ber.png"),
                   metric="ber",
                   title="All 12 IEEE 802.11n codes, 8-bit OMS layered, "
                         "20 iters")
    print("done", flush=True)


if __name__ == "__main__":
    main()
