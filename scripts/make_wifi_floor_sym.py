"""Two-method reconciliation of the wifi-648 deep floor (round 5).

The published OMS 5.0 dB floor (results/error_floor_wifi648.*) came from
the capped-census radial-ladder estimator: 1.10e-12 (three seeds
0.63-1.4e-12). The round-5 symmetry-folded estimator with the COMPLETE
a<=8 b<=3 absorbing-orbit cover measured 3.1-3.4e-12 at 200k CPU frames
— a ~3x method gap. Both are unbiased; the difference is coverage
(the ladder capped at 64 census sets; symmetric covers every orbit but
each with fewer effective frames). This script runs the symmetric
estimator at device scale (2M frames, three seeds, OMS + NMS, 4.6/5.0 dB)
so the method gap is measured with tight errors, and records both
methods' values side by side.

Run: PYTHONPATH=. python scripts/make_wifi_floor_sym.py
Writes results/wifi_floor_sym.json.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = "results/wifi_floor_sym.json"


def main():
    import jax
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from ldpc_tpu.analysis.asenum import enumerate_sets
    from ldpc_tpu.codes.ieee80211n import make_code
    from ldpc_tpu.config import CodeConfig, DecoderConfig, QuantConfig, \
        SimConfig
    from ldpc_tpu.sim.impsamp import (canonical_rotation,
                                      estimate_fer_symmetric,
                                      expand_radial, make_symmetric_run)

    code = make_code(648, "1/2")
    r = enumerate_sets(code, a_max=8, b_max=3, dv_cap=3, emit_min_a=5,
                       emit_cap=16384)
    reps = sorted(set(canonical_rotation(code, S)
                      for (a, b, f, S) in r.sets if f))
    print(f"{len(reps)} absorbing orbit reps (a<=8 b<=3)", flush=True)
    reps_x, deltas = expand_radial(reps, [1.2, 1.6, 2.0])

    doc = {"config": "wifi-648 r=1/2 8-bit scale-4 layered 20it ET; "
                     "symmetric estimator, COMPLETE a<=8 b<=3 absorbing "
                     "orbit cover x ladder [1.2,1.6,2.0], pi0=0.25, "
                     "batch 8192, 2M frames/seed",
           "ladder_method_reference": {
               "oms_5.0": 1.10e-12,
               "note": "results/error_floor_wifi648 (capped census sets "
                       "+ radial ladder, three seeds 0.63-1.4e-12)"},
           "rows": []}
    for alg, blsb, aname in (("offset-min-sum", 1, "oms_b1"),
                             ("normalized-min-sum", 0, "nms_a34")):
        quant = (QuantConfig(bits=8, scale=4.0, beta_lsb=blsb)
                 if alg == "offset-min-sum" else
                 QuantConfig(bits=8, scale=4.0, beta_lsb=0, alpha_num=3,
                             alpha_shift=2))
        cfg = SimConfig(code=CodeConfig(), quant=quant,
                        decoder=DecoderConfig(algorithm=alg, max_iter=20,
                                              schedule="layered",
                                              early_term=True))
        run = make_symmetric_run(code, cfg, reps_x, delta=deltas,
                                 pi0=0.25, batch=8192)
        for snr in (4.6, 5.0):
            for seed in (31, 32, 33):
                t0 = time.time()
                est = estimate_fer_symmetric(
                    code, cfg, reps_x, ebn0_db=snr, frames=2_097_152,
                    delta=deltas, pi0=0.25, batch=8192, seed=seed,
                    run=run)
                est.update({"alg": aname, "seed": seed,
                            "wall_s": round(time.time() - t0, 1)})
                doc["rows"].append(est)
                print(f"{aname} {snr} dB s{seed}: {est['fer']:.3e} "
                      f"+-{est['rel_std']:.2f} ({est['wall_s']}s)",
                      flush=True)
                with open(OUT, "w") as f:
                    json.dump(doc, f, indent=1)
    print("done", flush=True)


if __name__ == "__main__":
    main()
