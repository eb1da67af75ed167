"""Generate the canonical BER/FER waterfall artifact set on the GPU.

Produces results/wifi648_{minsum,oms,oms_float}.{json,csv} and a combined
waterfall plot — the reference's headline output (BER/FER vs Eb/N0 with the
fixed-vs-float quantization-bound comparison, BASELINE.json:2/5).

Run: PYTHONPATH=. python scripts/make_waterfall.py [outdir]
"""
import dataclasses
import os
import sys
import time

from ldpc_tpu.config import PRESETS
from ldpc_tpu.sim import Sweep
from ldpc_tpu.sim.report import plot_waterfall, write_outputs


def main():
    import jax
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results"
    os.makedirs(outdir, exist_ok=True)
    base = PRESETS["wifi-648-r12-minsum"]
    ebn0 = [1.0, 1.5, 2.0, 2.5, 3.0, 3.5]
    runs = {
        # the canonical parity config: plain min-sum, fixed 20 iterations
        "wifi648_minsum": base,
        # 8-bit offset-min-sum with early termination
        "wifi648_oms": dataclasses.replace(
            base,
            quant=dataclasses.replace(base.quant, beta_lsb=2),
            decoder=dataclasses.replace(base.decoder,
                                        algorithm="offset-min-sum",
                                        early_term=True)),
        # float OMS — the quantization-bound comparison curve
        "wifi648_oms_float": dataclasses.replace(
            base,
            quant=dataclasses.replace(base.quant, beta_lsb=2),
            decoder=dataclasses.replace(base.decoder,
                                        algorithm="offset-min-sum-float",
                                        early_term=True)),
    }
    results = []
    for name, cfg in runs.items():
        t0 = time.time()
        sweep = Sweep(cfg, batch=16384, superbatches=8,
                      checkpoint_path=os.path.join(outdir, name + ".state"))
        res = sweep.run(ebn0, target_frame_errors=200,
                        max_frames=2_000_000)
        res.code_name = name  # legend label
        write_outputs(res, os.path.join(outdir, name))
        results.append(res)
        print(f"{name}: {time.time()-t0:.0f}s [{res.decoder_backend}]",
              flush=True)
    for metric in ("ber", "fer"):
        plot_waterfall(results, os.path.join(outdir, f"wifi648_{metric}.png"),
                       metric=metric,
                       title="802.11n n=648 r=1/2, 8-bit min-sum family, "
                             "20 iters")
    print("done", flush=True)


if __name__ == "__main__":
    main()
