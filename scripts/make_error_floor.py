"""Error-floor study: trapping-set harvesting + mixture importance sampling.

For 8-bit OMS and NMS on 802.11n n=648 r=1/2:
  1. harvest decoder failures at the waterfall knee on the real decode
     backend, refine them to trapping-set cores (analysis/trapping.py);
  2. grow the candidate pool by greedy search seeded with those cores;
  3. estimate FER down the floor region with defensive mixture IS
     (sim/impsamp.py) — unbiased, bounded weights — and cross-validate
     against plain Monte-Carlo at overlap SNRs where both resolve.

Writes results/error_floor_wifi648.{json,png}.

Usage: PYTHONPATH=. python scripts/make_error_floor.py [--platform cpu]
       [--quick]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

# categorical palette (dataviz reference instance, light mode)
C_OMS, C_NMS = "#2a78d6", "#eb6834"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/error_floor_wifi648")
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from ldpc_tpu.analysis.trapping import (classify, dominant_sets,
                                            refine_support,
                                            search_trapping_sets)
    from ldpc_tpu.codes.ieee80211n import make_code
    from ldpc_tpu.config import DecoderConfig, QuantConfig, SimConfig
    from ldpc_tpu.sim.impsamp import (estimate_fer, harvest_error_supports,
                                      make_is_run)

    code = make_code(648, "1/2")
    if args.quick:
        batch, h_frames, mc_frames, is_frames = 512, 4096, 8192, 8192
        mc_snrs, is_snrs = [2.6, 3.0], [2.6, 3.0, 3.4]
    else:
        batch, h_frames, mc_frames, is_frames = 8192, 131072, 2_000_000, \
            1_000_000
        mc_snrs = [2.6, 3.0, 3.4]
        is_snrs = [2.6, 3.0, 3.4, 3.8, 4.2, 4.6, 5.0]

    out = {"code": "802.11n n=648 r=1/2", "batch": batch,
           "algorithms": {}}
    for alg, beta in (("offset-min-sum", 2), ("normalized-min-sum", 0)):
        cfg = SimConfig(quant=QuantConfig(bits=8, scale=4.0, beta_lsb=beta),
                        decoder=DecoderConfig(algorithm=alg, max_iter=20,
                                              schedule="layered"))
        t0 = time.time()
        # harvest at the knee (FER ~1e-2): rich failure statistics; the
        # same small cores dominate the floor at higher SNR
        sup = harvest_error_supports(code, cfg, ebn0_db=2.2,
                                     frames=h_frames, batch=batch, seed=11,
                                     max_supports=512)
        cores = sorted({refine_support(code, s) for s in sup[:128]
                        if len(s) <= 24},
                       key=lambda s: sorted(s))
        found = search_trapping_sets(code, a_max=10, b_max=4, seeds=cores,
                                     max_sets=768)
        # Round-5 methodology (the round-4 harvest-only proposal missed
        # the (6,2)/(6,3) absorbing mechanism entirely and underestimated
        # the deep OMS floor 30-500x — results/floor_validate.json,
        # floor_ladder.json):
        #   proposal = EXACT census absorbing sets (the provably complete
        #   list of small attractors) + harvested cores + searched sets,
        #   each at a RADIAL LADDER of shift depths; stratified lanes.
        from ldpc_tpu.analysis.asenum import enumerate_sets
        from ldpc_tpu.sim.impsamp import expand_radial
        r = enumerate_sets(code, a_max=8, b_max=3, dv_cap=3,
                           emit_min_a=4, emit_cap=200_000)
        absorbing = sorted([(a, b, S) for (a, b, f, S) in r.sets if f],
                           key=lambda t: (t[0] + t[1], t[0]))
        dom = list(dict.fromkeys(
            [frozenset(S) for (_, _, S) in absorbing[:40]]
            + [c for c in cores if 3 <= len(c) <= 16]
            + dominant_sets(found, k=48, min_a=4)))[:64]
        classes = sorted({classify(code, s) for s in dom})
        depths = [1.2, 1.6, 2.0, 2.4]
        is_sets, is_deltas = expand_radial([sorted(s) for s in dom], depths)
        print(f"{alg}: {len(sup)} failures -> {len(cores)} cores; "
              f"{len(absorbing)} exact absorbing -> {len(dom)} supports "
              f"x {len(depths)} depths, classes {classes[:10]} "
              f"({time.time()-t0:.0f}s)", flush=True)

        run_mc = make_is_run(code, cfg, sets=[], batch=batch)
        run_is = make_is_run(code, cfg, sets=is_sets, delta=is_deltas,
                             batch=batch, pi0=0.25, stratify=True)
        rows = {"harvest": {"failures": len(sup),
                            "proposal_sets": len(dom),
                            "exact_absorbing_a8b3": len(absorbing),
                            "radial_depths": depths,
                            "classes": [list(c) for c in classes]},
                "mc": [], "is": []}
        for snr in mc_snrs:
            est = estimate_fer(code, cfg, sets=[], ebn0_db=snr,
                               frames=mc_frames, batch=batch, seed=21,
                               run=run_mc)
            rows["mc"].append(est.to_dict())
            print(f"  MC  {snr} dB: FER {est.fer:.3e} +-{est.rel_std:.2f} "
                  f"({est.raw_hits:.0f} hits)", flush=True)
        for snr in is_snrs:
            # crossover region (waterfall tail still dominates, defensive
            # component starves — docs/PERFORMANCE.md caveat): 4x frames
            nframes = is_frames * (4 if 2.8 <= snr <= 3.9 else 1)
            est = estimate_fer(code, cfg, sets=is_sets, delta=is_deltas,
                               ebn0_db=snr, frames=nframes, batch=batch,
                               seed=31, run=run_is)
            rows["is"].append(est.to_dict())
            print(f"  IS  {snr} dB: FER {est.fer:.3e} +-{est.rel_std:.2f} "
                  f"({est.raw_hits:.0f} raw hits; plain-MC floor "
                  f"{est.fer_plain_ci95:.1e})", flush=True)
        out["algorithms"][alg] = rows

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=1)

    # ---- plot: FER vs Eb/N0, color = algorithm, marker = method ---------
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    for alg, color in (("offset-min-sum", C_OMS),
                       ("normalized-min-sum", C_NMS)):
        rows = out["algorithms"][alg]
        for method, style in (("mc", dict(marker="o", mfc="none", ls="none",
                                          label=f"{alg} plain MC")),
                              ("is", dict(marker="D", ls="--", ms=5,
                                          label=f"{alg} mixture IS"))):
            pts = [r for r in rows[method] if r["fer"] > 0]
            if not pts:
                continue
            x = [r["ebn0_db"] for r in pts]
            y = [r["fer"] for r in pts]
            yerr = [[min(2 * r["rel_std"], 0.99) * r["fer"] for r in pts],
                    [2 * r["rel_std"] * r["fer"] for r in pts]]
            ax.errorbar(x, y, yerr=yerr, color=color, lw=2, capsize=3,
                        **style)
    ax.set_yscale("log")
    ax.set_xlabel("Eb/N0 (dB)")
    ax.set_ylabel("FER")
    ax.set_title("Error floor via trapping-set mixture IS — "
                 "802.11n n=648 r=1/2, 8-bit, layered 20it")
    ax.grid(True, which="both", alpha=0.25, lw=0.5)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.out + ".png", dpi=140)
    print("done", flush=True)


if __name__ == "__main__":
    main()
