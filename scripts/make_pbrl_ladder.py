"""PBRL-style rate-compatible ladder vs naive puncturing — same rates,
same info size, same decoder family.

The raptor-like construction (codes/peg.py pbrl_construct) exists for
exactly this: a mother code whose extension parities are DESIGNED to be
punctured, versus the naive ladder that tail-punctures a dual-diagonal
code's staircase (results/rate_ladder_wifi648.*). Both ladders carry
k=324 info bits at effective rates 0.50/0.57/0.67/0.75; per-rung
protograph-DE thresholds (rate matching modeled) are computed alongside
the silicon waterfalls, so the analysis layer's prediction and the
measurement land in one artifact.

Writes results/pbrl_ladder.{json,png} + per-rung csv/json (PBRL rungs;
the naive rungs are read from results/rate_ladder_wifi648.json).

Usage: PYTHONPATH=. python scripts/make_pbrl_ladder.py [--platform cpu]
       [--quick]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

# categorical palette (dataviz reference instance) — color = rate rung
RATE_COLORS = {"r0.50": "#2a78d6", "r0.57": "#eb6834",
               "r0.67": "#1baf7a", "r0.75": "#eda100"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/pbrl_ladder")
    ap.add_argument("--naive", default="results/rate_ladder_wifi648.json")
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from ldpc_tpu.analysis.proto_de import proto_de_threshold_awgn
    from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                                 QuantConfig, RunConfig, SimConfig)
    from ldpc_tpu.sim import Sweep, build_code
    from ldpc_tpu.sim.report import write_outputs

    quant = QuantConfig(bits=8, scale=4.0, beta_lsb=2)
    # PBRL mother: kb=12, cb=4 core, 12 extension rows, Z=27 (n=756,
    # k=324). punct_frac counts fractions of the 432 parity bits.
    rungs = [
        ("r0.50", 108 / 432, [1.0, 1.5, 2.0, 2.5, 3.0]),
        ("r0.57", 189 / 432, [1.5, 2.0, 2.5, 3.0, 3.5]),
        ("r0.67", 270 / 432, [2.0, 2.5, 3.0, 3.5, 4.0]),
        ("r0.75", 324 / 432, [2.5, 3.0, 3.5, 4.0, 4.5]),
    ]
    if args.quick:
        rungs = [(n, f, e[1:3]) for n, f, e in rungs[:2]]
        batch, max_frames, tfe = 512, 2048, 20
    else:
        batch, max_frames, tfe = 16384, 1_000_000, 200

    def cfg_for(frac):
        return SimConfig(
            # design picked by the proto-DE knob scan (round-4 scan,
            # recorded in the output JSON): ext_row_degree=4 with a
            # 2x3+3x6+4x3 core beats naive puncturing by 0.8/1.6 dB at
            # rates 0.67/0.75 (predicted), conceding 0.4 dB at 0.50.
            code=CodeConfig(family="pbrl", n=756, rate="3/7", Z=27,
                            core_rows=4, ext_row_degree=4, code_seed=0,
                            profile="2,2,2,3,3,3,3,3,3,4,4,4",
                            punct_frac=frac),
            channel=ChannelConfig(modulation="bpsk"), quant=quant,
            decoder=DecoderConfig(algorithm="offset-min-sum",
                                  schedule="layered", max_iter=20,
                                  early_term=True),
            run=RunConfig(seed=1))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    results, meta = [], []
    for name, frac, ebn0 in rungs:
        cfg = cfg_for(frac)
        code = build_code(cfg)
        t0 = time.time()
        thr = proto_de_threshold_awgn(code, quant, beta=2,
                                      bracket=(0.4, 1.2))
        import numpy as np
        rate = code.rate
        thr_db = float(-20 * np.log10(thr * np.sqrt(2 * rate)))
        sw = Sweep(cfg, batch=batch, superbatches=4,
                   checkpoint_path=args.out + f".{name}.state")
        res = sw.run(ebn0, target_frame_errors=tfe, max_frames=max_frames)
        res.code_name = f"pbrl {name} (n_tx={code.n_tx})"
        write_outputs(res, args.out + f".{name}")
        results.append(res)
        meta.append({"rung": name, "punct_frac": frac, "n_tx": code.n_tx,
                     "rate": rate, "proto_de_threshold_db": round(thr_db, 3),
                     "backend": res.decoder_backend})
        print(f"{name}: rate {rate:.3f} proto-DE* {thr_db:.2f} dB "
              f"{time.time()-t0:.0f}s [{res.decoder_backend}]", flush=True)

    # the naive rungs' own proto-DE thresholds, for the JSON record
    from ldpc_tpu.codes.ieee80211n import make_code as _mk_wifi
    from ldpc_tpu.codes.rate_compat import puncture as _punct
    import numpy as np
    naive_thr = {}
    wifi = _mk_wifi(648, "1/2")
    for name, nfrac in (("r0.50", 0.0), ("r0.57", 0.25), ("r0.67", 0.5),
                        ("r0.75", 2.0 / 3.0)):
        if not any(name == r[0] for r in rungs):
            continue
        c = _punct(wifi, frac=nfrac) if nfrac else wifi
        t = proto_de_threshold_awgn(c, quant, beta=2, bracket=(0.35, 1.2))
        naive_thr[name] = round(
            float(-20 * np.log10(t * np.sqrt(2 * c.rate))), 3)
    print(f"naive proto-DE*: {naive_thr}", flush=True)

    naive = {}
    if os.path.exists(args.naive):
        nd = json.load(open(args.naive))
        for cname, rows in nd["curves"].items():
            for name, _, _ in rungs:
                if f"punct {name} " in cname:
                    naive[name] = rows

    # ---- plot: color = rate rung, linestyle = construction ------------
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7.5, 5))
    for (name, _, _), res in zip(rungs, results):
        col = RATE_COLORS[name]
        rows = [r for r in res.rows() if r["fer"] > 0]
        ax.plot([r["ebn0_db"] for r in rows], [r["fer"] for r in rows],
                color=col, lw=2, marker="D", ms=5,
                label=f"PBRL {name}")
        if name in naive:
            rows = [r for r in naive[name] if r["fer"] > 0]
            ax.plot([r["ebn0_db"] for r in rows], [r["fer"] for r in rows],
                    color=col, lw=2, ls="--", marker="o", mfc="none",
                    label=f"naive {name}")
    ax.set_yscale("log")
    ax.set_xlabel("Eb/N0 (dB)")
    ax.set_ylabel("FER")
    ax.set_title("Rate-compatible ladders, k=324, 8-bit OMS layered 20it: "
                 "PBRL-designed vs naive tail puncturing")
    ax.grid(True, which="both", alpha=0.25, lw=0.5)
    ax.legend(fontsize=8, ncol=2)
    fig.tight_layout()
    fig.savefig(args.out + ".png", dpi=140)

    with open(args.out + ".json", "w") as f:
        json.dump({"rungs": meta, "naive_proto_de_thresholds": naive_thr,
                   "design_scan_note": "ext_row_degree in {2,3,4} x 3 core "
                   "profiles scanned by proto DE; erd=4 core 2x3+3x6+4x3 "
                   "won every rung of the scan",
                   "curves": {r.code_name: r.rows() for r in results},
                   "naive_source": args.naive}, f, indent=1)
    print("done", flush=True)


if __name__ == "__main__":
    main()
