"""Round-5 DVB-S2 n=64800 deep-floor study: symmetry-folded mixture IS.

Methodology (the round-4 failure and its fix, in full):
  * results/dvb_mc_deep.json measured the floor DIRECTLY to 1.4 dB
    (info-FER 1.0e-7) and identified the mechanism: (L,2) accumulator
    chains at ARBITRARY positions + info-bit/chain compounds. Round-4's
    proposal covered 24 of ~30k chains; its deep points were low by up
    to 6 decades and are retracted.
  * sim/impsamp.make_symmetric_run covers ONE canonical representative
    per QC orbit and Z-folds attributed contributions (x360), so the
    proposal covers the whole mechanism class with ~450 components.
  * Convergence bar: seed repeatability at EVERY point + cross-
    validation against the three MC anchors (1.25/1.3/1.4 dB). Points
    that fail either bar are reported as such, not as estimates.

Proposal: all (L,2) chain orbit reps (L = 1..4, every start block),
canonicalized info-failure supports harvested by the MC probe, and the
(7,3) absorbing orbit rep — each at radial-ladder depths.

Run: PYTHONPATH=. python scripts/make_dvb_floor_r5.py [--quick]
Writes results/dvb_floor_r5.json incrementally.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = "results/dvb_floor_r5.json"


def main():
    quick = "--quick" in sys.argv
    import jax
    if quick:
        jax.config.update("jax_platforms", "cpu")
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from ldpc_tpu.codes.dvbs2 import make_code
    from ldpc_tpu.config import CodeConfig, DecoderConfig, QuantConfig, \
        SimConfig
    from ldpc_tpu.sim.impsamp import (canonical_rotation,
                                      estimate_fer_symmetric,
                                      expand_radial, make_symmetric_run)

    code = make_code(n=64800, rate="1/2")
    Z = int(code.Z)
    kb = code.k // Z
    mb = (code.n - code.k) // Z
    cfg = SimConfig(code=CodeConfig(family="dvbs2", n=64800, rate="1/2"),
                    quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
                    decoder=DecoderConfig(algorithm="offset-min-sum",
                                          max_iter=20, schedule="layered",
                                          early_term=True))

    # 1. NO pure-chain reps: (L,2) accumulator chains are PARITY-ONLY
    #    events (results/dvb_mc_deep.json: zero info bits in every pure-
    #    chain failure) — they cannot produce an info-FER event, and a
    #    first pass that spent 354 of 463 reps on them starved the real
    #    mechanism of frames (measured 5-2000x low vs the MC anchors
    #    with 40x seed scatter). The info-failure mechanism is the
    #    COMPOUND class (one info bit + several chains), harvested next.
    reps = []
    n_chain = 0
    del kb, mb  # chain generation retired

    # 2. canonicalized info-failure supports from the MC probe (the
    #    compound info-bit + chains mechanism, measured not guessed)
    n_harvest = 0
    try:
        with open("results/dvb_mc_deep.json") as f:
            mc = json.load(f)
        seen = set(reps)
        for pt in mc["points"]:
            for s in pt["supports"]:
                if s["n_info"] > 0 and 1 <= s["size"] <= 48:
                    c = canonical_rotation(code, s["support"])
                    if c not in seen:
                        seen.add(c)
                        reps.append(c)
                        n_harvest += 1
    except FileNotFoundError:
        pass

    # 3. the (7,3) absorbing orbit (exhaustive census, dvb_census.json)
    try:
        with open("results/dvb_census.json") as f:
            cen = json.load(f)
        c = canonical_rotation(code, cen["example_73_sets"][0])
        if c not in set(reps):
            reps.append(c)
    except FileNotFoundError:
        pass

    print(f"{len(reps)} orbit reps ({n_chain} chains, {n_harvest} "
          f"harvested compounds)", flush=True)
    if quick:
        reps = reps[:24]
    deltas_l = [1.4, 2.0] if quick else [1.2, 1.6, 2.0]
    reps_x, deltas = expand_radial(reps, deltas_l)
    batch = 256 if quick else 1024
    frames = 2048 if quick else 2_097_152
    run = make_symmetric_run(code, cfg, reps_x, delta=deltas, pi0=0.25,
                             batch=batch)

    doc = {"config": f"DVB-S2 n=64800 r=1/2_like, 8-bit scale-4 OMS "
                     f"beta=2LSB layered 20it ET, batch {batch}; "
                     f"symmetry-folded mixture IS: {len(reps)} orbit reps "
                     f"(pure parity-chain reps EXCLUDED - parity-only events, "
                     f"{n_harvest} MC-harvested info-compound orbits, (7,3) orbit) "
                     f"x ladder {deltas_l}, pi0=0.25, exact M0/M Z-fold x{Z}",
           "mc_anchors": {"1.25": 8.7e-6, "1.3": 1.4e-6, "1.4": 1.0e-7},
           "retracted_round4": {"1.3": 8.8e-12, "1.4": 6.9e-13,
                                "1.6": 8.0e-17},
           "points": {}}
    snrs = [1.3] if quick else [1.25, 1.3, 1.4, 1.5, 1.6]
    for snr in snrs:
        rows = []
        for seed in (71, 72):
            t0 = time.time()
            est = estimate_fer_symmetric(
                code, cfg, reps_x, ebn0_db=snr, frames=frames,
                delta=deltas, pi0=0.25, batch=batch, seed=seed, run=run)
            est["wall_s"] = round(time.time() - t0, 1)
            rows.append(est)
            print(f"{snr} dB s{seed}: FER {est['fer']:.3e} "
                  f"+-{est['rel_std']:.2f} (zfold "
                  f"{est['fer_attributed_zfold']:.3e}, rem "
                  f"{est['fer_unattributed']:.3e}, raw "
                  f"{est['raw_hits']}, {est['wall_s']}s)", flush=True)
        doc["points"][str(snr)] = rows
        with open(OUT, "w") as f:
            json.dump(doc, f, indent=1)
    print("done", flush=True)


if __name__ == "__main__":
    main()
