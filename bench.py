"""Benchmark driver — runs on an NVIDIA GPU and refuses to run anywhere else.

Default mode measures decoded information bits per second on the canonical
config (802.11n n=648 rate-1/2, BPSK/AWGN, 8-bit fixed-point min-sum,
flooding, 20 fixed iterations — BASELINE.json:7) through the full jitted
pipeline (encode -> modulate -> AWGN -> demap -> quantize -> decode ->
counters) and prints ONE JSON line. `python bench.py --all` adds one line
for each extended workload.

Every line names the device it ran on (platform, device_kind, device count)
and the decoder the pipeline resolved. Timing: one warm-up call compiles,
then the median over `reps` calls, each waited for with block_until_ready.
Compilation is reported separately (compile_s).
"""
import dataclasses
import json
import statistics
import sys
import time

import numpy as np

CONFIG = "wifi-648-r12-minsum"


def _cfg(name):
    """Extended-workload configs: preset + the measured operating point."""
    from ldpc_tpu.config import PRESETS
    if name == CONFIG:
        return PRESETS[CONFIG]
    if name == "dvbs2-64800-r12":
        return PRESETS["dvbs2-64800-r12"]
    if name == "dvbs2-64800-r12-et":
        cfg = PRESETS["dvbs2-64800-r12"]
        return dataclasses.replace(
            cfg,
            channel=dataclasses.replace(cfg.channel, ebn0_db=2.6),
            decoder=dataclasses.replace(cfg.decoder, early_term=True))
    if name == "dvbs2-16200-r12-et":
        cfg = PRESETS["dvbs2-64800-r12"]
        return dataclasses.replace(
            cfg,
            code=dataclasses.replace(cfg.code, n=16200),
            channel=dataclasses.replace(cfg.channel, ebn0_db=2.2),
            decoder=dataclasses.replace(cfg.decoder, early_term=True))
    if name == "nr-bg1-z384":
        return PRESETS["nr-bg1-layered"]
    if name == "qam16-1944-chain":
        cfg = PRESETS["multihost-qam-chain"]
        return dataclasses.replace(
            cfg, run=dataclasses.replace(cfg.run, mesh_shape=None))
    if name == "wifi-648-minstar":
        cfg = PRESETS[CONFIG]
        return dataclasses.replace(
            cfg,
            quant=dataclasses.replace(cfg.quant, beta_lsb=0),
            decoder=dataclasses.replace(cfg.decoder, algorithm="min-star",
                                        schedule="layered",
                                        early_term=True))
    raise KeyError(name)


# name -> (batch, superbatches, reps)
WORKLOADS = {
    CONFIG: (16384, 8, 10),
    "dvbs2-64800-r12": (1024, 1, 5),
    "dvbs2-64800-r12-et": (1024, 1, 5),
    "dvbs2-16200-r12-et": (1024, 2, 5),
    "nr-bg1-z384": (256, 4, 5),
    "qam16-1944-chain": (16384, 2, 5),
    "wifi-648-minstar": (16384, 2, 5),
}


def require_gpu():
    """The device every result is labelled with; exits when JAX finds no
    GPU (a CPU number must never pass for a device measurement)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX platform "
                 f"{devs[0].platform!r}); nothing measured")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def measure(name):
    """-> dict of the workload's numbers."""
    import jax
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.sim import build_code, make_run_batch

    cfg = _cfg(name)
    batch, sb, reps = WORKLOADS[name]
    code = build_code(cfg)
    rb = make_run_batch(code, cfg, batch=batch, superbatches=sb)
    sigma = np.float32(sigma_for(cfg.channel.ebn0_db, code.rate,
                                 cfg.channel.modulation))
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    jax.block_until_ready(rb(key, sigma))
    compile_s = time.perf_counter() - t0
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(rb(jax.random.fold_in(key, r + 1), sigma))
        times.append(time.perf_counter() - t0)
    per_batch = statistics.median(times) / sb
    return {"info_bps": batch * code.k_eff / per_batch,
            "ms_per_batch": per_batch * 1e3, "compile_s": compile_s,
            "backend": rb.backend_label, "batch": batch}


def main() -> None:
    from ldpc_tpu.utils.cache import enable_compile_cache

    device = require_gpu()
    enable_compile_cache()
    names = list(WORKLOADS) if "--all" in sys.argv else [CONFIG]
    for name in names:
        r = measure(name)
        print(json.dumps({
            "metric": f"info_bps[{name}]", "value": r["info_bps"],
            "unit": "bit/s", "ms_per_batch": r["ms_per_batch"],
            "batch": r["batch"], "compile_s": r["compile_s"],
            "backend": r["backend"], "device": device}), flush=True)


if __name__ == "__main__":
    main()
