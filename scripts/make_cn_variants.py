"""CN-update algorithm comparison artifact (the reference's MATLAB-style
algorithm study): plain min-sum vs offset-min-sum (beta in {1,2,3} LSB) vs
normalized-min-sum (alpha=3/4) vs float OMS, all on the canonical 802.11n
n=648 r=1/2 code, 8-bit quantization, layered, 20 iterations, same seeds.

Writes results/cn_variants_{name}.{json,csv} per variant and the combined
plot results/cn_variants_ber.png. Run on the GPU:
  PYTHONPATH=. python scripts/make_cn_variants.py [outdir]

Caveat: the float-OMS row runs FLOODING (the float decoders' only
schedule), so it is not the quantization-bound comparison — that lives in
results/wifi648_oms_float (same schedule as its fixed counterpart). Here
the fixed layered rows beating float flooding reflects layered's ~2x
per-iteration convergence at the fixed 20-iteration budget.
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, ".")

import jax

from ldpc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

# --only NAME: run a single variant row; --platform cpu: run on the CPU
# (every BER row is platform-independent).
# Parsed BEFORE the ldpc_tpu imports: importing the sim package
# initializes the JAX backend, after which jax_platforms is latched.
_args = [a for a in sys.argv[1:]]
_only = None
if "--only" in _args:
    _i = _args.index("--only")
    _only = _args[_i + 1]
    del _args[_i:_i + 2]
if "--platform" in _args:
    _i = _args.index("--platform")
    jax.config.update("jax_platforms", _args[_i + 1])
    del _args[_i:_i + 2]

from ldpc_tpu.config import PRESETS
from ldpc_tpu.sim import Sweep
from ldpc_tpu.sim.report import plot_waterfall, write_outputs


def main():
    args, only = _args, _only
    outdir = args[0] if args else "results"
    os.makedirs(outdir, exist_ok=True)
    base = PRESETS["wifi-648-r12-minsum"]
    base = dataclasses.replace(
        base, decoder=dataclasses.replace(base.decoder, schedule="layered",
                                          early_term=True))
    variants = {
        "minsum": dict(algorithm="min-sum", beta_lsb=0),
        "oms_b1": dict(algorithm="offset-min-sum", beta_lsb=1),
        "oms_b2": dict(algorithm="offset-min-sum", beta_lsb=2),
        "oms_b3": dict(algorithm="offset-min-sum", beta_lsb=3),
        "nms_a34": dict(algorithm="normalized-min-sum", alpha_num=3,
                        alpha_shift=2),
        "oms_float": dict(algorithm="offset-min-sum-float", beta_lsb=2),
        # round-5: the min* family (threshold-LUT approx sum-product,
        # QC-XLA decoder) + its float sum-product target — quantifies
        # the min*-vs-OMS gain and the min*-vs-SP residual on silicon
        "minstar": dict(algorithm="min-star", beta_lsb=0),
        "sp_float": dict(algorithm="sum-product", beta_lsb=0),
    }
    ebn0 = [1.5, 2.0, 2.5, 3.0]
    results = []
    if only:
        variants = {only: variants[only]}
    for name, kv in variants.items():
        alg = kv.pop("algorithm")
        # float rows run flooding: the historical contract for *-float
        sched = ("flooding" if alg.endswith("-float")
                 or alg == "sum-product" else "layered")
        cfg = dataclasses.replace(
            base,
            quant=dataclasses.replace(base.quant, **kv),
            decoder=dataclasses.replace(base.decoder, algorithm=alg,
                                        schedule=sched))
        t0 = time.time()
        sweep = Sweep(cfg, batch=16384, superbatches=4,
                      checkpoint_path=os.path.join(
                          outdir, f"cn_variants_{name}.state"))
        res = sweep.run(ebn0, target_frame_errors=300, max_frames=500_000)
        res.code_name = name
        write_outputs(res, os.path.join(outdir, f"cn_variants_{name}"))
        results.append(res)
        print(f"{name}: {time.time()-t0:.0f}s [{res.decoder_backend}]",
              flush=True)
    if not only:
        plot_waterfall(results, os.path.join(outdir, "cn_variants_ber.png"),
                       metric="ber",
                       title="CN update variants, 802.11n n=648 r=1/2, "
                             "8-bit, layered 20 it")
    print("done", flush=True)


if __name__ == "__main__":
    main()
