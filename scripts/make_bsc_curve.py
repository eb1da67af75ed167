"""BER-vs-flip-probability curve over the BSC fault injector (SURVEY.md §5.3).

Stress-tests the decoder with hard bit-flip faults (ops/channel.bsc) instead
of soft AWGN noise: for each flip probability p, run the full chain
encode -> bsc -> bsc_llr -> quantize -> decode and record BER/FER. Writes
results/bsc_wifi648.{json,csv,png}.

Usage: python scripts/make_bsc_curve.py [--platform cpu] [--frames 4096]
"""
import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--out", default="results/bsc_wifi648")
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops import channel as ch
    from ldpc_tpu.ops.encode import make_encoder, info_positions
    from ldpc_tpu.ops.quantize import quantize
    from ldpc_tpu.sim import build_code
    from ldpc_tpu.sim.pipeline import select_decoder

    cfg = PRESETS["wifi-648-r12-minsum"]
    code = build_code(cfg)
    B = min(args.frames, 4096)
    n_batches = max(1, args.frames // B)
    enc = make_encoder(code)
    dec, backend = select_decoder(code, cfg, "auto", batch=B)
    info_pos = jnp.asarray(info_positions(code))

    def run(key, p):
        ki, kf = jax.random.split(key)
        info = jax.random.bernoulli(ki, 0.5, (B, code.k)).astype(jnp.uint8)
        cw = enc(info)
        rx = ch.bsc(kf, cw, p)
        q = quantize(ch.bsc_llr(rx, p), cfg.quant)
        hard, iters, conv = dec(q)
        err = hard[:, info_pos] != info
        return jnp.stack([jnp.sum(err, dtype=jnp.int32),
                          jnp.sum(jnp.any(err, axis=-1), dtype=jnp.int32),
                          jnp.sum(conv, dtype=jnp.int32)])

    run_j = jax.jit(run)
    ps = [0.005, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.08]
    rows = []
    for i, p in enumerate(ps):
        tot = np.zeros(3, np.int64)
        for b in range(n_batches):
            key = jax.random.fold_in(jax.random.PRNGKey(11), i * 1000 + b)
            tot += np.asarray(run_j(key, np.float32(p)), np.int64)
        frames = B * n_batches
        rows.append({"p": p, "frames": frames,
                     "ber": tot[0] / (frames * code.k),
                     "fer": tot[1] / frames,
                     "conv_rate": tot[2] / frames})
        print(rows[-1], flush=True)

    with open(args.out + ".json", "w") as f:
        json.dump({"config": "wifi-648-r12-minsum over BSC", "backend": backend,
                   "results": rows}, f, indent=1)
    with open(args.out + ".csv", "w") as f:
        f.write("p,frames,ber,fer,conv_rate\n")
        for r in rows:
            f.write(f"{r['p']},{r['frames']},{r['ber']},{r['fer']},"
                    f"{r['conv_rate']}\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 4.5))
        ax.semilogy([r["p"] for r in rows],
                    [max(r["ber"], 1e-9) for r in rows], "o-", label="BER")
        ax.semilogy([r["p"] for r in rows],
                    [max(r["fer"], 1e-9) for r in rows], "s--", label="FER")
        ax.set_xlabel("BSC flip probability p")
        ax.set_ylabel("error rate")
        ax.set_title("802.11n n=648 r=1/2 min-sum over BSC (fault injection)")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.out + ".png", dpi=120)
    except Exception as e:  # matplotlib optional
        print(f"plot skipped: {e}")
    print(f"wrote {args.out}.json/.csv/.png")


if __name__ == "__main__":
    main()
