"""Radial-ladder deep-floor estimation: convergence check (round-5).

Single-depth (delta=2.0) proposals scattered 5e-14..9e-12 across seeds at
5.0 dB (results/floor_validate.json) — heavy-tailed weights from radial
mismatch. This run uses the ladder (every exact-census absorbing set at
depths 1.2/1.6/2.0/2.4) with stratified allocation, at THREE independent
seeds: the estimator is declared converged only if the seeds agree within
their reported errors.

Run: PYTHONPATH=. python scripts/diag_floor_ladder.py
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
    from ldpc_tpu.codes.ieee80211n import make_code
    from ldpc_tpu.config import DecoderConfig, QuantConfig, SimConfig
    from ldpc_tpu.sim.impsamp import estimate_fer, expand_radial, make_is_run

    code = make_code(648, "1/2")
    cfg = SimConfig(quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
                    decoder=DecoderConfig(algorithm="offset-min-sum",
                                          max_iter=20, schedule="layered"))
    batch, frames = 8192, 4_000_000
    r = enumerate_sets(code, a_max=8, b_max=3, dv_cap=3, emit_min_a=4,
                       emit_cap=200_000)
    absorbing = sorted([(a, b, S) for (a, b, f, S) in r.sets if f],
                       key=lambda t: (t[0] + t[1], t[0]))
    exact64 = [list(S) for (_, _, S) in absorbing[:64]]
    depths = [1.2, 1.6, 2.0, 2.4]
    sets, deltas = expand_radial(exact64, depths)
    print(f"{len(exact64)} sets x {depths} -> {len(sets)} components",
          flush=True)
    run = make_is_run(code, cfg, sets=sets, delta=deltas, batch=batch,
                      pi0=0.25, stratify=True)
    doc = {"depths": depths, "n_sets": len(exact64), "frames": frames,
           "points": {}}
    for snr in (4.5, 5.0):
        rows = []
        for seed in (51, 52, 53):
            t0 = time.time()
            est = estimate_fer(code, cfg, sets=sets, delta=deltas,
                               ebn0_db=snr, frames=frames, batch=batch,
                               seed=seed, run=run)
            rows.append({"seed": seed, "fer": est.fer,
                         "rel_std": est.rel_std, "raw": est.raw_hits})
            print(f"{snr} dB seed {seed}: FER {est.fer:.3e} "
                  f"+-{est.rel_std:.2f} ({est.raw_hits} raw, "
                  f"{time.time()-t0:.0f}s)", flush=True)
        doc["points"][str(snr)] = rows
        with open("results/floor_ladder.json", "w") as f:
            json.dump(doc, f, indent=1)


if __name__ == "__main__":
    main()
