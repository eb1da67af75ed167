"""Quantization bit-width study: BER/FER waterfalls for b-bit fixed point.

The reference class of simulator exists to answer exactly this question:
how much does b-bit fixed-point quantization cost vs the float decoder?
Each bit width gets the practitioner's Q-format (narrow widths trade clip
range for resolution: +-8 LLR at 4 bits up to +-31.75 at the canonical 8;
a 4-bit quantizer at the 8-bit range is resolution-starved and measures
~0.19 BER at 2 dB where the +-8 range measures a working waterfall).
Writes results/bits_wifi648.{json,csv,png}.

Usage: python scripts/make_bits_study.py [--platform cpu] [--frames N]
"""
import argparse
import json
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--frames", type=int, default=262144)
    ap.add_argument("--bits", type=int, nargs="*", default=[4, 5, 6, 8])
    ap.add_argument("--ebn0", type=float, nargs="*",
                    default=[1.0, 1.5, 2.0, 2.5, 3.0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--out", default="results/bits_wifi648")
    args = ap.parse_args()
    import dataclasses

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim.sweep import Sweep

    # 802.11n n=648 r=1/2, OMS + ET (the same operating config as the
    # results/wifi648_oms artifacts, so the 8-bit curve cross-checks).
    base = PRESETS["wifi-648-r12-minsum"]
    base = dataclasses.replace(
        base,
        decoder=dataclasses.replace(base.decoder,
                                    algorithm="offset-min-sum",
                                    early_term=True),
        run=dataclasses.replace(base.run, batch=args.batch,
                                max_frames=args.frames))
    # LLR clip range per width (range/resolution trade; 8-bit = canonical).
    CLIP = {2: 2.0, 3: 4.0, 4: 8.0, 5: 12.0, 6: 16.0, 7: 24.0, 8: 31.75}
    rows = []
    for b in args.bits:
        qmax = (1 << (b - 1)) - 1
        clip = CLIP.get(b, 31.75)
        # beta scales with the Q-format: 2 LSB at 8 bits (the wifi648_oms
        # operating choice) = 0.5 LLR; >=1 LSB at narrower widths.
        quant = dataclasses.replace(
            base.quant, bits=b, scale=qmax / clip,
            beta_lsb=max(1, round(0.5 * qmax / clip)))
        cfg = dataclasses.replace(base, quant=quant)
        sw = Sweep(cfg, superbatches=8)
        res = sw.run(args.ebn0, target_frame_errors=200)
        for p in res.points:
            r = p.row(res.k, res.n)
            r["bits"] = b
            rows.append(r)
            print(json.dumps({"bits": b, "ebn0_db": r["ebn0_db"],
                              "ber": r["ber"], "fer": r["fer"]}), flush=True)

    with open(args.out + ".json", "w") as f:
        json.dump({"rows": rows}, f, indent=1)
    import csv
    with open(args.out + ".csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 5))
        for b in args.bits:
            pts = [(r["ebn0_db"], r["ber"]) for r in rows if r["bits"] == b]
            ax.semilogy(*zip(*pts), marker="o", label=f"{b}-bit")
        ax.set_xlabel("Eb/N0 (dB)")
        ax.set_ylabel("BER")
        ax.set_title("802.11n n=648 r=1/2 OMS: fixed-point bit-width study")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.savefig(args.out + ".png", dpi=120, bbox_inches="tight")
    except Exception as e:  # matplotlib is optional on minimal images
        print(f"plot skipped: {e}")
    print("wrote:", args.out + ".{json,csv,png}")


if __name__ == "__main__":
    main()
