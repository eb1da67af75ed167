"""Smoke test of the LDPC simulator on one NVIDIA GPU, through the entry
points a user calls. Run from the root of the repository:

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the 4-card mesh path only

Phases, in order (one process; any failure exits non-zero before the last
line is printed):
  1. device       JAX's devices and the card's name and power limit; fails
                  unless the platform is a GPU;
  2. kernel       the CUDA decode kernel against ops/decode_qc.py on
                  identical int8 LLRs at real widths (802.11n n=648 r1/2 at
                  B=16384 flooding fixed-20; n=1944 r3/4 layered OMS with
                  early termination), a 64-frame slice of each against
                  golden/decoder.py — all with zero tolerance — then the
                  card-only tests (pytest -m gpu);
  3. flagship     a few superbatches of wifi-648-r12-minsum through
                  make_run_batch; frames == B x calls and the FER at 2.0 dB
                  overlaps the stored interval in results/wifi648_minsum.json;
  4. large code   two batches of DVB-S2 n=64800 through decode_qc;
  5. fused sweep  Sweep.run_fused over 3 points; counters add up.
With --four-cards only this runs: the flagship and the 16-QAM chain on a
4-card flat mesh and on one card, same seed and global batch; the counters
must be identical.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def phase(name):
    print(f"== {name}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_phase():
    import jax
    phase("device")
    devs = jax.devices()
    print("jax.devices():", devs)
    for d in devs:
        print(f"  platform={d.platform} device_kind={d.device_kind}")
    check(devs[0].platform == "gpu",
          f"no GPU: JAX platform is {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print("nvidia-smi:", smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return devs


def channel_llrs(code, cfg, batch, ebn0_db, seed):
    """int8 LLRs through the repo's own chain: random info bits, encoder,
    modulation, AWGN, demapper, quantizer."""
    import jax
    from ldpc_tpu.ops import channel as ch
    from ldpc_tpu.ops.encode import make_encoder
    from ldpc_tpu.ops.quantize import quantize

    mod = cfg.channel.modulation
    sigma = ch.sigma_for(ebn0_db, code.rate, mod)
    enc = make_encoder(code)

    @jax.jit
    def make(key):
        kinfo, knoise = jax.random.split(key)
        info = jax.random.bernoulli(kinfo, 0.5, (batch, code.k))
        x = ch.modulate(enc(info.astype(np.uint8)), mod)
        y = ch.awgn(knoise, x, sigma)
        return quantize(ch.demap(y, sigma, mod), cfg.quant)

    return make(jax.random.PRNGKey(seed))


def kernel_phase():
    import jax
    from ldpc_tpu.config import PRESETS, cn_params
    from ldpc_tpu.golden.decoder import decode_fixed
    from ldpc_tpu.kernels import minsum_cuda
    from ldpc_tpu.ops.decode_qc import make_decoder as make_qc
    from ldpc_tpu.sim import build_code

    phase("kernel")
    flag = PRESETS["wifi-648-r12-minsum"]
    qam = PRESETS["multihost-qam-chain"]
    cases = [("wifi648-r12 flooding fixed-20", flag, 2.0),
             ("wifi1944-r34 layered OMS ET", qam, 3.0)]
    for name, cfg, ebn0 in cases:
        code = build_code(cfg)
        dec = cfg.decoder
        q = channel_llrs(code, dataclasses.replace(
            cfg, channel=dataclasses.replace(cfg.channel, modulation="bpsk")),
            16384, ebn0, seed=7)
        kern = jax.jit(minsum_cuda.make_decoder(code, dec, cfg.quant))
        ref = jax.jit(make_qc(code, dec, cfg.quant))
        for label, f in (("cuda kernel", kern), ("decode_qc", ref)):
            print(f"  {name}: {label} memory_analysis:",
                  f.lower(q).compile().memory_analysis(), flush=True)
        t0 = time.perf_counter()
        out = [np.asarray(a) for a in jax.block_until_ready(kern(q))]
        t1 = time.perf_counter()
        want = [np.asarray(a) for a in jax.block_until_ready(ref(q))]
        t2 = time.perf_counter()
        for a, b, what in zip(out, want, ("hard", "iters", "conv")):
            bad = int((a != b).reshape(len(a), -1).any(axis=1).sum())
            check(bad == 0, f"{name}: {bad} frames differ in {what} "
                            f"between the kernel and decode_qc")
        beta, alpha = cn_params(dec, cfg.quant)
        qn = np.asarray(q[:64]).astype(np.int32)
        for i in range(64):
            g = decode_fixed(qn[i], code, max_iter=dec.max_iter, beta=beta,
                             alpha=alpha, qmax=cfg.quant.qmax,
                             schedule=dec.schedule,
                             early_term=dec.early_term)
            check(np.array_equal(g.hard, out[0][i])
                  and g.iters == out[1][i] and g.converged == out[2][i],
                  f"{name}: frame {i} differs from golden")
        print(f"  {name}: B=16384 kernel == decode_qc (0 mismatches), "
              f"64 frames == golden; first calls (compile + run): kernel "
              f"{t1 - t0:.2f} s, decode_qc {t2 - t1:.2f} s; "
              f"converged {out[2].mean():.4f}", flush=True)

    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_cuda_kernel.py")])
    check(rc == 0, f"card-only tests failed (pytest exit code {rc})")


def run_counters(rb, n_calls, sigma, seed=0):
    import jax
    acc = None
    for c in range(n_calls):
        out = np.asarray(rb(jax.random.fold_in(jax.random.PRNGKey(seed), c),
                            sigma))
        acc = out if acc is None else acc + out
    return acc


def flagship_phase():
    import jax
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.sim import build_code, make_run_batch
    from ldpc_tpu.sim.stats import wilson_interval

    phase("flagship")
    cfg = PRESETS["wifi-648-r12-minsum"]
    code = build_code(cfg)
    B, sb, calls = 16384, 4, 4
    rb = make_run_batch(code, cfg, batch=B, superbatches=sb)
    print("  backend label:", rb.backend_label)
    check(rb.backend_label == "qc-cuda",
          f"flagship resolved to {rb.backend_label}, not the CUDA kernel")
    sigma = np.float32(sigma_for(2.0, code.rate, "bpsk"))
    jax.block_until_ready(rb(jax.random.PRNGKey(99), sigma))
    t0 = time.perf_counter()
    c = run_counters(rb, calls, sigma)
    dt = time.perf_counter() - t0
    frames, bit_errs, frame_errs = int(c[0]), int(c[1]), int(c[2])
    check(frames == B * sb * calls, f"frames {frames} != {B * sb * calls}")
    with open(os.path.join(ROOT, "results", "wifi648_minsum.json")) as f:
        stored = next(r for r in json.load(f)["results"]
                      if r["ebn0_db"] == 2.0)
    lo, hi = wilson_interval(frame_errs, frames)
    print(f"  2.0 dB: frames={frames} frame_errs={frame_errs} "
          f"FER={frame_errs / frames:.5f} [{lo:.5f}, {hi:.5f}] vs stored "
          f"[{stored['fer_lo']:.5f}, {stored['fer_hi']:.5f}]; "
          f"BER={bit_errs / (frames * code.k):.3e}; {dt:.3f} s for "
          f"{calls} calls", flush=True)
    check(lo <= stored["fer_hi"] and stored["fer_lo"] <= hi,
          "flagship FER at 2.0 dB does not overlap the stored interval")


def large_code_phase():
    import jax
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.sim import build_code, make_run_batch

    phase("large code")
    cfg = PRESETS["dvbs2-64800-r12"]
    code = build_code(cfg)
    B, calls = 1024, 2
    rb = make_run_batch(code, cfg, batch=B)
    print("  backend label:", rb.backend_label)
    check(rb.backend_label == "qc-jnp",
          f"DVB-S2 n=64800 resolved to {rb.backend_label}")
    sigma = np.float32(sigma_for(cfg.channel.ebn0_db, code.rate, "bpsk"))
    t0 = time.perf_counter()
    compiled = rb.lower(jax.random.PRNGKey(0), sigma).compile()
    print(f"  compile {time.perf_counter() - t0:.1f} s; memory_analysis:",
          compiled.memory_analysis(), flush=True)
    c = run_counters(rb, calls, sigma)
    check(int(c[0]) == B * calls, f"frames {int(c[0])} != {B * calls}")
    print(f"  DVB-S2 n=64800 at {cfg.channel.ebn0_db} dB: frames={int(c[0])}"
          f" frame_errs={int(c[2])} bit_errs={int(c[1])}", flush=True)


def fused_phase():
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.sim import Sweep

    phase("fused sweep")
    cfg = PRESETS["wifi-648-r12-minsum"]
    B, sb, per_point = 3 * 4096, 2, 4 * 4096 * 2
    sw = Sweep(cfg, batch=B, superbatches=sb)
    res = sw.run_fused([1.5, 2.0, 2.5], target_frame_errors=10 ** 12,
                       max_frames=per_point)
    k = sw.code.k
    for p in res.points:
        print(f"  {p.ebn0_db} dB: frames={p.frames} frame_errs="
              f"{p.frame_errs} bit_errs={p.bit_errs} converged={p.converged}"
              f" iter_sum={p.iter_sum}")
        check(p.frames == per_point, f"{p.ebn0_db} dB: {p.frames} frames")
        check(0 <= p.frame_errs <= p.frames
              and p.frame_errs <= p.bit_errs <= p.frames * k
              and p.converged <= p.frames
              and p.iter_sum == p.frames * cfg.decoder.max_iter,
              f"{p.ebn0_db} dB: counters do not add up")
    fer = [p.frame_errs / p.frames for p in res.points]
    check(fer[0] > fer[1] > fer[2], f"FER not decreasing with SNR: {fer}")
    print("  backend label:", res.decoder_backend, flush=True)


def four_cards_phase():
    import jax
    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.parallel import make_mesh
    from ldpc_tpu.sim import build_code, make_run_batch

    phase("four cards")
    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(devices=devs)
    qam = PRESETS["multihost-qam-chain"]
    qam = dataclasses.replace(qam, run=dataclasses.replace(
        qam.run, mesh_shape=(4,), mesh_axes=("batch",)))
    for name, cfg, B, ebn0 in (
            ("wifi-648-r12-minsum", PRESETS["wifi-648-r12-minsum"], 16384,
             2.0),
            ("multihost-qam-chain", qam, 4096, 6.0)):
        code = build_code(cfg)
        sigma = np.float32(sigma_for(ebn0, code.rate,
                                     cfg.channel.modulation))
        outs = {}
        for label, m in (("1 card", None), ("4 cards", mesh)):
            rb = make_run_batch(code, cfg, batch=B, mesh=m, superbatches=2)
            t0 = time.perf_counter()
            outs[label] = run_counters(rb, 3, sigma, seed=11)
            print(f"  {name} {label}: backend={rb.backend_label} counters="
                  f"{outs[label].tolist()} ({time.perf_counter() - t0:.2f}"
                  f" s incl. compile)", flush=True)
        check(np.array_equal(outs["1 card"], outs["4 cards"]),
              f"{name}: 1-card and 4-card counters differ")
        check(int(outs["1 card"][0]) == B * 2 * 3, f"{name}: frame count")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its 1-card "
                         "comparison")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from ldpc_tpu.utils.cache import enable_compile_cache

    devs = device_phase()
    enable_compile_cache()
    if args.four_cards:
        four_cards_phase()
    else:
        kernel_phase()
        flagship_phase()
        large_code_phase()
        fused_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
