"""BER/FER curves for the wider code-family set, on the GPU.

Produces results/: 802.11n n=1944 (r=1/2 and r=5/6, OMS layered — the
'wifi-full-oms' capability), 5G-NR-like BG1, and DVB-S2-like r=1/2 via the
QC-XLA decoder. Run: PYTHONPATH=. python scripts/make_family_curves.py
"""
import os
import sys
import time

import jax

from ldpc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                             QuantConfig, RunConfig, SimConfig)
from ldpc_tpu.sim import Sweep
from ldpc_tpu.sim.report import plot_waterfall, write_outputs


def cfg_for(family, **kw):
    quant = QuantConfig(bits=8, scale=4.0, beta_lsb=2)
    dec = DecoderConfig(algorithm="offset-min-sum", schedule=kw.pop(
        "schedule", "layered"), max_iter=20,
        early_term=kw.pop("early_term", True))
    return SimConfig(code=CodeConfig(family=family, **kw),
                     channel=ChannelConfig(modulation="bpsk"),
                     quant=quant, decoder=dec, run=RunConfig(seed=1))


RUNS = {
    "wifi1944_r12_oms": (cfg_for("ieee80211n", n=1944, rate="1/2"),
                         [0.75, 1.0, 1.25, 1.5, 1.75, 2.0], 16384, 200_000),
    "wifi1944_r56_oms": (cfg_for("ieee80211n", n=1944, rate="5/6"),
                         [2.5, 3.0, 3.5, 4.0], 16384, 200_000),
    "nr_bg1_z128_r13": (cfg_for("5gnr", base_graph=1, Z=128, rate="1/3"),
                        [0.0, 0.5, 1.0, 1.5], 4096, 100_000),
    "dvbs2_r12_stream": (cfg_for("dvbs2", n=64800, rate="1/2",
                                 early_term=False),
                         [1.0, 1.25, 1.5], 1024, 20_000),
}


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results"
    os.makedirs(outdir, exist_ok=True)
    results = []
    for name, (cfg, ebn0, batch, max_frames) in RUNS.items():
        t0 = time.time()
        sweep = Sweep(cfg, batch=batch, superbatches=4,
                      checkpoint_path=os.path.join(outdir, name + ".state"))
        res = sweep.run(ebn0, target_frame_errors=150, max_frames=max_frames)
        res.code_name = name
        write_outputs(res, os.path.join(outdir, name))
        results.append(res)
        print(f"{name}: {time.time()-t0:.0f}s [{res.decoder_backend}]",
              flush=True)
    plot_waterfall(results, os.path.join(outdir, "families_ber.png"),
                   metric="ber", title="Code families, 8-bit OMS, 20 iters")
    print("done", flush=True)


if __name__ == "__main__":
    main()
