"""Rate-compatible puncturing ladder on the 802.11n n=648 r=1/2 mother code.

One decoder graph, four effective rates via nested tail puncturing
(codes/rate_compat.py; CodeConfig.punct_frac): the incremental-redundancy
capability of rate-compatible LDPC research. Each rung is swept on the GPU
through the standard pipeline (punctured positions enter the decoder with
LLR 0; Eb/N0 calibration follows k_eff/n_tx automatically).

Writes results/rate_ladder_wifi648.{json,png} + per-rung csv/json.

Usage: PYTHONPATH=. python scripts/make_rate_ladder.py [--platform cpu]
       [--quick]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/rate_ladder_wifi648")
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                                 QuantConfig, RunConfig, SimConfig)
    from ldpc_tpu.sim import Sweep, build_code
    from ldpc_tpu.sim.report import plot_waterfall, write_outputs

    # punct_frac -> effective rate r = 324 / (648 - frac*324)
    rungs = [
        ("r0.50", 0.0, [1.0, 1.5, 2.0, 2.5, 3.0]),
        ("r0.57", 0.25, [1.5, 2.0, 2.5, 3.0, 3.5]),
        ("r0.67", 0.5, [2.0, 2.5, 3.0, 3.5, 4.0]),
        ("r0.75", 2.0 / 3.0, [2.5, 3.0, 3.5, 4.0, 4.5]),
    ]
    if args.quick:
        rungs = [(n, f, e[1:3]) for n, f, e in rungs[:2]]
        batch, max_frames, tfe = 512, 2048, 20
    else:
        batch, max_frames, tfe = 16384, 1_000_000, 200

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    results, meta = [], []
    for name, frac, ebn0 in rungs:
        cfg = SimConfig(
            code=CodeConfig(family="ieee80211n", n=648, rate="1/2",
                            punct_frac=frac),
            channel=ChannelConfig(modulation="bpsk"),
            quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
            decoder=DecoderConfig(algorithm="offset-min-sum",
                                  schedule="layered", max_iter=20,
                                  early_term=True),
            run=RunConfig(seed=1))
        code = build_code(cfg)
        t0 = time.time()
        sw = Sweep(cfg, batch=batch, superbatches=4,
                   checkpoint_path=args.out + f".{name}.state")
        res = sw.run(ebn0, target_frame_errors=tfe, max_frames=max_frames)
        res.code_name = f"wifi648 punct {name} (n_tx={code.n_tx})"
        write_outputs(res, args.out + f".{name}")
        results.append(res)
        meta.append({"rung": name, "punct_frac": frac,
                     "n_tx": code.n_tx, "rate": code.rate,
                     "punct_count": int(len(code.punct_vns)),
                     "backend": res.decoder_backend})
        print(f"{name}: rate {code.rate:.3f} {time.time()-t0:.0f}s "
              f"[{res.decoder_backend}]", flush=True)

    plot_waterfall(results, args.out + ".png", metric="fer",
                   title="Rate-compatible ladder from one n=648 r=1/2 "
                         "mother code (nested tail puncturing)")
    with open(args.out + ".json", "w") as f:
        json.dump({"rungs": meta,
                   "curves": {r.code_name: r.rows() for r in results}},
                  f, indent=1)
    print("done", flush=True)


if __name__ == "__main__":
    main()
