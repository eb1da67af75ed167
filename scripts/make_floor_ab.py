"""Round-5 deep-floor A/B: does the exact absorbing SPECTRUM predict the
DEEP error floor (where the 3 dB tail A/B falsified it)?

Context (results/census_ab.json): at 3.0 dB the spectrum-ranked seed s2
measured WORSE than s7 — the waterfall-floor transition is still
short-cycle-dominated (c6 order s7 3888 < s2 4077 matches the measured
tail). The deep floor is where absorbing sets should rule.

Falsifiable prediction, stated before measurement: at 5.0 dB the FER
order is standard < s2 < s7 — standard's smallest absorbing class is
(6,2) x 27, s2's is (6,2) x 54 (NO a=5 sets), s7 carries 108 (5,3) sets
whose smaller a dominates deep down (per-set hit probability rises as a
falls).

Method: mixture IS with the proposal built ENTIRELY from the exact
census (absorbing sets, smallest a+b first, K=64) + stratified lane
allocation — no harvesting. Cross-validation anchors:
  * 3.0 dB IS vs the 4M-frame plain-MC FER measured in census_ab.json
    (unbiasedness on each code);
  * standard @ 4.2-5.0 dB vs round-4's HARVEST-proposal IS
    (results/error_floor_wifi648.json OMS rows: 3.2e-11 / 8.9e-14 /
    2.8e-14) — two different unbiased proposals must agree.

Config matches round-4's floor study: 8-bit scale-4 OMS beta=2LSB,
layered, 20 iters, ET; batch 8192.

Run: PYTHONPATH=. python scripts/make_floor_ab.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    quick = "--quick" in sys.argv
    out = "results/floor_ab"
    import jax
    if "--platform" in sys.argv:
        jax.config.update(
            "jax_platforms", sys.argv[sys.argv.index("--platform") + 1])
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from ldpc_tpu.analysis.asenum import enumerate_sets
    from ldpc_tpu.codes.ieee80211n import make_code as make_wifi
    from ldpc_tpu.codes.peg import qc_peg_construct
    from ldpc_tpu.config import DecoderConfig, QuantConfig, SimConfig
    from ldpc_tpu.sim.impsamp import estimate_fer, make_is_run

    wifi = make_wifi(648, "1/2")
    degs = np.sort((wifi.base[:, :12] >= 0).sum(axis=0))
    codes = {"standard": wifi}
    for s in (2, 7):
        codes[f"qcpeg-s{s}"] = qc_peg_construct(
            kb=12, cb=12, Z=27, col_degrees=degs, seed=s)

    cfg = SimConfig(quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
                    decoder=DecoderConfig(algorithm="offset-min-sum",
                                          max_iter=20, schedule="layered"))
    if quick:
        batch, base_frames = 512, 4096
        points = [(3.0, 2), (5.0, 1)]
    else:
        batch, base_frames = 8192, 1_000_000
        points = [(3.0, 4), (4.0, 1), (4.5, 1), (5.0, 1)]

    from ldpc_tpu.sim.impsamp import expand_radial
    depths = [1.2, 1.6, 2.0, 2.4]
    doc = {"config": "8-bit scale-4 OMS beta=2LSB layered 20it ET, "
                     "batch 8192; proposal = exact census absorbing sets "
                     "(a<=8 b<=3 dv_cap=3, smallest a+b, K<=64) x radial "
                     f"ladder {depths}, stratified, pi0=0.25; two seeds "
                     "per point (convergence check)",
           "prediction": "deep-floor (5.0 dB) order standard < s2 < s7 "
                         "(absorbing spectrum); 3.0 dB expected to echo "
                         "census_ab.json plain MC (unbiasedness)",
           "codes": {}}
    for name, code in codes.items():
        t0 = time.time()
        r = enumerate_sets(code, a_max=8, b_max=3, dv_cap=3,
                           emit_min_a=4, emit_cap=200_000)
        absorbing = [(a, b, S) for (a, b, f, S) in r.sets if f]
        absorbing.sort(key=lambda t: (t[0] + t[1], t[0]))
        dom = [list(S) for (_, _, S) in absorbing[:64]]
        classes = sorted({(a, b) for (a, b, _) in absorbing[:64]})
        sets, deltas = expand_radial(dom, depths)
        print(f"{name}: {len(absorbing)} absorbing (exhaustive), "
              f"proposal {len(dom)}x{len(depths)} classes {classes} "
              f"({time.time()-t0:.0f}s)", flush=True)
        run = make_is_run(code, cfg, sets=sets, delta=deltas, batch=batch,
                          pi0=0.25, stratify=True)
        rows = []
        for snr, mult in points:
            for seed in (41, 42):
                t0 = time.time()
                est = estimate_fer(code, cfg, sets=sets, delta=deltas,
                                   ebn0_db=snr, frames=base_frames * mult,
                                   batch=batch, seed=seed, run=run)
                d = est.to_dict()
                d["seed"] = seed
                rows.append(d)
                print(f"  {name} {snr} dB s{seed}: FER {est.fer:.3e} "
                      f"+-{est.rel_std:.2f} ({est.raw_hits:.0f} raw, "
                      f"{time.time()-t0:.0f}s)", flush=True)
        doc["codes"][name] = {
            "absorbing_total_a8b3": len(absorbing),
            "proposal_classes": [list(c) for c in classes],
            "is": rows}
        with open(out + ".json", "w") as f:
            json.dump(doc, f, indent=1)
    print("wrote", out + ".json", flush=True)


if __name__ == "__main__":
    main()
