"""Hard-decision decoder study over the BSC (SURVEY.md §5.3 extension).

Compares the hard-decision decoders (ops/decode_hard: Gallager-B, parallel
bit-flipping) against the soft 8-bit min-sum chain and the uncoded channel
on two codes:

  * 802.11n n=648 r=1/2 — the canonical irregular standard code. Shows the
    documented degree-2 pathology: Gallager-B collapses (46% of variables
    sit on the dual-diagonal parity chain) while bit-flipping degrades
    gracefully and soft min-sum dominates.
  * (3,6)-regular array code (codes/toy.array_qc) — the regime Gallager's
    analysis covers; message passing beats bit-flipping there.

Writes results/bsc_hard_wifi648.{json,csv,png}.

Usage: python scripts/make_hard_curve.py [--platform cpu] [--frames 2048]
"""
import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--out", default="results/bsc_hard_wifi648")
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    from ldpc_tpu.codes.toy import array_qc
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops import channel as ch
    from ldpc_tpu.ops.decode_hard import make_hard_decoder
    from ldpc_tpu.ops.encode import make_encoder, info_positions
    from ldpc_tpu.ops.quantize import quantize
    from ldpc_tpu.sim import build_code
    from ldpc_tpu.sim.pipeline import select_decoder

    cfg = PRESETS["wifi-648-r12-minsum"]
    wifi = build_code(cfg)
    reg = array_qc()
    B = min(args.frames, 2048)
    n_batches = max(1, args.frames // B)
    enc = make_encoder(wifi)
    soft_dec, backend = select_decoder(wifi, cfg, "auto", batch=B)
    info_pos = jnp.asarray(info_positions(wifi))
    hard_decs = {alg: jax.jit(make_hard_decoder(wifi, max_iter=30,
                                                algorithm=alg))
                 for alg in ("gallager-b", "bit-flip")}
    reg_decs = {alg: jax.jit(make_hard_decoder(reg, max_iter=30,
                                               algorithm=alg))
                for alg in ("gallager-b", "bit-flip")}

    def run_wifi(key, p):
        """-> bit/frame error counts per decoder on the wifi info bits."""
        ki, kf = jax.random.split(key)
        info = jax.random.bernoulli(ki, 0.5, (B, wifi.k)).astype(jnp.uint8)
        cw = enc(info)
        rx = ch.bsc(kf, cw, p)
        outs = {}
        q = quantize(ch.bsc_llr(rx, p), cfg.quant)
        soft_hard, _, _ = soft_dec(q)
        for name, hard in [("min-sum-8bit", soft_hard)] + [
                (alg, hard_decs[alg](rx)[0]) for alg in hard_decs]:
            err = hard[:, info_pos] != info
            outs[name] = jnp.stack([
                jnp.sum(err, dtype=jnp.int32),
                jnp.sum(jnp.any(err, axis=-1), dtype=jnp.int32)])
        outs["uncoded"] = jnp.stack([
            jnp.sum(rx[:, info_pos] != info, dtype=jnp.int32),
            jnp.sum(jnp.any(rx[:, info_pos] != info, axis=-1),
                    dtype=jnp.int32)])
        return outs

    def run_reg(key, p):
        """All-zeros codeword on the regular code (not encodable)."""
        y = ch.bsc(key, jnp.zeros((B, reg.n), jnp.uint8), p)
        outs = {}
        for alg, dec in reg_decs.items():
            hard, _, _ = dec(y)
            outs[alg] = jnp.stack([
                jnp.sum(hard != 0, dtype=jnp.int32),
                jnp.sum(jnp.any(hard != 0, axis=-1), dtype=jnp.int32)])
        return outs

    run_wifi_j, run_reg_j = jax.jit(run_wifi), jax.jit(run_reg)
    ps = [0.005, 0.01, 0.02, 0.03, 0.04, 0.06]
    frames = B * n_batches
    rows = []
    for i, p in enumerate(ps):
        tot = {}
        for b in range(n_batches):
            key = jax.random.fold_in(jax.random.PRNGKey(13), i * 1000 + b)
            kw, kr = jax.random.split(key)
            for name, v in run_wifi_j(kw, np.float32(p)).items():
                tot[name] = tot.get(name, 0) + np.asarray(v, np.int64)
            for name, v in run_reg_j(kr, np.float32(p)).items():
                k = "regular/" + name
                tot[k] = tot.get(k, 0) + np.asarray(v, np.int64)
        row = {"p": p, "frames": frames}
        for name, v in tot.items():
            bits = reg.n if name.startswith("regular/") else wifi.k
            row[name] = {"ber": float(v[0] / (frames * bits)),
                         "fer": float(v[1] / frames)}
        rows.append(row)
        print(row, flush=True)

    curves = [k for k in rows[0] if k not in ("p", "frames")]
    with open(args.out + ".json", "w") as f:
        json.dump({"study": "hard-decision decoders over BSC",
                   "wifi_code": wifi.name, "regular_code": reg.name,
                   "soft_backend": backend, "results": rows}, f, indent=1)
    with open(args.out + ".csv", "w") as f:
        f.write("p,frames," + ",".join(
            f"{c}_ber,{c}_fer" for c in curves) + "\n")
        for r in rows:
            f.write(f"{r['p']},{r['frames']}," + ",".join(
                f"{r[c]['ber']},{r[c]['fer']}" for c in curves) + "\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        # NOT sharey-labeled as one metric: the wifi panel counts info-bit
        # errors, the regular array code has no systematic encoder so its
        # panel counts codeword-bit errors over all n bits (advisor
        # finding, round 2) — label each panel with its own metric.
        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5), sharey=True)
        panels = [("802.11n n=648 r=1/2 (irregular)",
                   ["uncoded", "bit-flip", "gallager-b", "min-sum-8bit"]),
                  ("(3,6)-regular array code n=102",
                   ["regular/bit-flip", "regular/gallager-b"])]
        for ax, (title, names) in zip(axes, panels):
            for name in names:
                ax.semilogy([r["p"] for r in rows],
                            [max(r[name]["ber"], 1e-8) for r in rows],
                            "o-", label=name.split("/")[-1])
            ax.set_xlabel("BSC flip probability p")
            ax.set_title(title)
            ax.grid(True, which="both", alpha=0.3)
            ax.legend()
        axes[0].set_ylabel("info BER")
        axes[1].set_ylabel("codeword BER (all n bits)")
        axes[1].yaxis.set_label_position("right")
        fig.tight_layout()
        fig.savefig(args.out + ".png", dpi=120)
    except Exception as e:  # matplotlib optional
        print(f"plot skipped: {e}")
    print(f"wrote {args.out}.json/.csv/.png")


if __name__ == "__main__":
    main()
