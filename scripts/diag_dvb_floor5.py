"""Round-5 DVB-S2 deep-floor re-examination with the corrected
methodology.

Round-4's results/dvb_floor.json (single-depth, (L,2)-chain + harvest
proposal) measured 6.9e-13 at 1.4 dB and 8.0e-17 at 1.6 dB. Two round-5
instruments question the deep points:
  * the exhaustive census (results/dvb_census.json) shows the (L,2)
    chains are NOT absorbing; the smallest absorbing structures are one
    QC orbit of 360 (7,3) sets the round-4 proposal never covered;
  * on wifi-648, exactly this proposal-coverage gap made the round-4
    floor estimates 30-500x low (results/floor_validate.json).
This run re-estimates 1.3/1.4/1.6 dB with the union proposal — (L,2)
chains + the full (7,3) absorbing orbit sample — at a radial ladder of
depths, stratified, two seeds per point.

Run: PYTHONPATH=. python scripts/diag_dvb_floor5.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from ldpc_tpu.analysis.asenum import enumerate_sets
    from ldpc_tpu.analysis.trapping import classify
    from ldpc_tpu.codes.dvbs2 import make_code
    from ldpc_tpu.config import CodeConfig, DecoderConfig, QuantConfig, \
        SimConfig
    from ldpc_tpu.sim.impsamp import estimate_fer, expand_radial, \
        make_is_run

    code = make_code(n=64800, rate="1/2")
    cfg = SimConfig(code=CodeConfig(family="dvbs2", n=64800, rate="1/2"),
                    quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
                    decoder=DecoderConfig(algorithm="offset-min-sum",
                                          max_iter=20, schedule="layered"))
    batch, frames = 1024, 524_288

    # (L,2) accumulator chains, L=2..4, sampled across the staircase
    # (round-4's structural proposal, 24 of them)
    Z = code.Z
    kb = code.k // Z
    chains = []
    for L in (2, 3, 4):
        for t0c in range(0, (code.n - code.k) // Z - L, 11):
            for r in (0, Z // 2):
                chains.append(sorted((kb + 1 + t0c + t) * Z + r
                                     for t in range(L)))
    chains = chains[:24]
    print("chain classes:", sorted({classify(code, c) for c in chains}),
          flush=True)

    t0 = time.time()
    r = enumerate_sets(code, a_max=7, b_max=3, dv_cap=3, emit_min_a=7,
                       emit_cap=200_000)
    orbit73 = [list(S) for (a, b, f, S) in r.sets if f][:40]
    print(f"(7,3) absorbing orbit: {len(orbit73)} of "
          f"{r.summary()['absorbing']} emitted ({time.time()-t0:.0f}s)",
          flush=True)

    focused = "--focused" in sys.argv
    if focused:
        # convergence-focused: fewer components x more lanes each
        # (the first pass spread 1024 lanes over 256 strata — ~3 lanes
        # per basin per batch — and seeds disagreed 6-30x)
        dom = chains[:12] + orbit73
        sets, deltas = expand_radial(dom, [1.6, 2.0])
        batch, frames_l = 4096, 1_000_000
    else:
        dom = chains + orbit73
        sets, deltas = expand_radial(dom, [1.2, 1.6, 2.0, 2.4])
        frames_l = frames
    run = make_is_run(code, cfg, sets=sets, delta=deltas, batch=batch,
                      pi0=0.25, stratify=True)
    doc = {"config": "DVB-S2 n=64800 r=1/2_like, 8-bit scale-4 OMS "
                     "beta=2LSB layered 20it ET, batch 1024; proposal = "
                     "24 (L,2) chains + 40 of the (7,3) absorbing orbit, "
                     "ladder [1.2,1.6,2.0,2.4], stratified, pi0=0.25",
           "round4_reference": {"1.3": 8.8e-12, "1.4": 6.9e-13,
                                "1.6": 8.0e-17},
           "points": {}}
    for snr in ((1.4, 1.6) if focused else (1.3, 1.4, 1.6)):
        rows = []
        for seed in (61, 62):
            t0 = time.time()
            est = estimate_fer(code, cfg, sets=sets, delta=deltas,
                               ebn0_db=snr, frames=frames_l, batch=batch,
                               seed=seed, run=run)
            rows.append({"seed": seed, "fer": est.fer,
                         "rel_std": est.rel_std, "raw": est.raw_hits})
            print(f"{snr} dB s{seed}: FER {est.fer:.3e} "
                  f"+-{est.rel_std:.2f} ({est.raw_hits} raw, "
                  f"{time.time()-t0:.0f}s)", flush=True)
        doc["points"][str(snr)] = rows
        with open("results/dvb_floor5_focused.json" if focused
                  else "results/dvb_floor5.json", "w") as f:
            json.dump(doc, f, indent=1)


if __name__ == "__main__":
    main()
