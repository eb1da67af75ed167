"""Deep plain-MC probe of the DVB-S2 n=64800 floor region (round 5).

Round-4/5 mixture-IS runs disagree across seeds by decades at 1.3-1.4 dB
(results/dvb_floor5*.json). The discrepancy signature is specific: the
divergent seeds each contain ONE near-max-weight hit (w ~= 1/pi0 = 4),
i.e. a failure in a region the mixture only reaches through its defensive
component. Repeatedly drawing such hits at ~1e-6 rate under q implies the
TRUE failure mass at these SNRs may be ~4e-6 — three to six decades ABOVE
the round-4 point estimates, not below.

Plain MC decides this directly: at ~12-22k frames/s through the ET stream
kernel, 1e7 frames resolves FER >= ~3e-7 at each point. If failures
appear, their harvested supports identify the mechanism the proposal is
missing; if none appear, the max-weight hits were flukes and a one-sided
bound analysis applies.

Run (in the background):
  PYTHONPATH=. python scripts/diag_dvb_mc_deep.py
Writes results/dvb_mc_deep.json incrementally.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = "results/dvb_mc_deep.json"


def main():
    import jax
    from ldpc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from ldpc_tpu.codes.dvbs2 import make_code
    from ldpc_tpu.config import CodeConfig, DecoderConfig, QuantConfig, \
        SimConfig
    from ldpc_tpu.ops import channel as ch
    from ldpc_tpu.ops.quantize import quantize
    from ldpc_tpu.sim.pipeline import select_decoder

    from ldpc_tpu.ops.encode import info_positions
    code = make_code(n=64800, rate="1/2")
    cfg = SimConfig(code=CodeConfig(family="dvbs2", n=64800, rate="1/2"),
                    quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
                    decoder=DecoderConfig(algorithm="offset-min-sum",
                                          max_iter=20, schedule="layered",
                                          early_term=True))
    batch = 1024
    dec, label = select_decoder(code, cfg, "auto", batch=batch)
    print("backend:", label, flush=True)
    tx = None  # all positions transmitted

    # FER convention: the artifact convention (estimate_fer, sweeps) is
    # INFO-bit frame error. Any-bit failures are ALSO counted here — for
    # an IRA code, parity-only failures are the accumulator-chain events,
    # and their rate vs info failures is itself a mechanism diagnostic.
    info_pos = jnp.asarray(np.asarray(info_positions(code)))

    @jax.jit
    def run(key, sigma):
        z = sigma * jax.random.normal(key, (batch, code.n))
        llr = ch.demap(1.0 + z, sigma, "bpsk")
        q = quantize(llr, cfg.quant)
        hard, _, _ = dec(q)
        fail_any = hard.any(axis=1)
        fail_info = (hard[:, info_pos] != 0).any(axis=1)
        return fail_info.sum(), fail_any.sum(), fail_any, hard

    gather = jax.jit(lambda hard, idx: jnp.take(hard, idx, axis=0))

    doc = {"config": "DVB-S2 n=64800 r=1/2_like, 8-bit scale-4 OMS "
                     "beta=2LSB layered 20it ET, batch 1024, plain MC, "
                     "all-zeros BPSK/AWGN",
           "purpose": "decide the 1.3-1.4 dB seed-discrepancy question: "
                      "is the true FER ~1e-6 (max-weight IS hits real) or "
                      "deep (hits were flukes)?",
           "points": []}
    # (snr, frames, seed) — 1.2 dB is the cheap anchor vs round-4 MC
    plan = [(1.2, 1_000_000, 71), (1.25, 10_000_000, 72),
            (1.3, 10_000_000, 73), (1.4, 10_000_000, 74)]
    if "--extend15" in sys.argv:
        # round-5 extension: push the direct measurement one more point
        # down the cliff (resolves FER >= ~3e-8 at 1e8 frames). --frames
        # and --seed allow splitting across runs (the first attempt
        # stalled at 37.9M frames / 0 fails — that run's evidence is
        # recorded in the summary from its log).
        fr = 100_000_000
        if "--frames" in sys.argv:
            fr = int(sys.argv[sys.argv.index("--frames") + 1])
        sd = 75
        if "--seed" in sys.argv:
            sd = int(sys.argv[sys.argv.index("--seed") + 1])
        snr_x = 1.5
        if "--snr" in sys.argv:
            snr_x = float(sys.argv[sys.argv.index("--snr") + 1])
        plan = [(snr_x, fr, sd)]
        global OUT  # separate artifact, merged by the analysis
        tag = str(snr_x).replace(".", "")
        OUT = f"results/dvb_mc_deep_{tag}_s{sd}.json"
    for snr, frames, seed in plan:
        sigma = ch.sigma_for(snr, code.rate, "bpsk")
        key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                 int(round(snr * 1000)))
        nb = frames // batch
        fails_info = fails_any = 0
        supports = []
        t0 = time.time()
        for i in range(nb):
            nfi, nfa, mask, hard = run(jax.random.fold_in(key, i), sigma)
            nfa = int(nfa)  # scalar fetch syncs the device step
            if nfa:
                bad = np.nonzero(np.asarray(mask))[0][:64]
                idx = np.zeros(64, np.int32)
                idx[:len(bad)] = bad
                rows = np.asarray(gather(hard, jnp.asarray(idx)))[:len(bad)]
                for r in rows:
                    s = np.nonzero(r)[0]
                    supports.append({
                        "size": int(len(s)),
                        "n_info": int((s < code.k).sum()),
                        "support": s[:256].tolist()})
                fails_any += nfa
                fails_info += int(nfi)
            if i % 500 == 499:
                el = time.time() - t0
                print(f"{snr} dB: {int((i+1)*batch)} frames, "
                      f"{fails_info} info-fails / {fails_any} any-fails, "
                      f"{(i+1)*batch/el:.0f} fr/s", flush=True)
            if i % 2000 == 1999:
                # incremental checkpoint: a stalled or killed run must not
                # lose its frames
                with open(OUT, "w") as f:
                    json.dump({**doc, "points": doc["points"] + [{
                        "ebn0_db": snr, "frames": (i + 1) * batch,
                        "fails_info": fails_info, "fails_any": fails_any,
                        "partial": True, "seed": seed}]}, f, indent=1)
        el = time.time() - t0
        N = nb * batch
        pt = {"ebn0_db": snr, "frames": N,
              "fails_info": fails_info, "fails_any": fails_any,
              "fer_info": fails_info / N, "fer_any": fails_any / N,
              "fer_ci95_upper_if_zero": 3.0 / N,
              "seconds": round(el, 1), "seed": seed,
              "supports": supports[:200]}
        doc["points"].append(pt)
        print(f"DONE {snr} dB: info {fails_info}/{N} -> "
              f"FER {fails_info/N:.3e}; any {fails_any}/{N} -> "
              f"{fails_any/N:.3e} ({el:.0f}s)", flush=True)
        with open(OUT, "w") as f:
            json.dump(doc, f, indent=1)


if __name__ == "__main__":
    main()
