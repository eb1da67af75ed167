"""Multi-process scaling-efficiency harness (BASELINE.md row 5 methodology).

Measures decoded-frames/s for 1 process and for N processes (each a
jax.distributed process owning `--devices` local devices), same global
config, and reports

    efficiency = throughput_Nproc / (N * throughput_1proc)

It forces the CPU: it demonstrates the multi-process launch path
(jax.distributed, one process per host) with fake CPU devices, and the N
processes SHARE the same physical cores, so its number is a lower bound on
what separate hosts would achieve (the only cross-process traffic is the
5-counter psum). It is not a device measurement. Scaling over the cards of
one host runs in one process: chip_smoke.py --four-cards.

Usage:
  python scripts/scaling_efficiency.py            # 1 vs 2 processes, CPU
  python scripts/scaling_efficiency.py --num-processes 4 --devices 2
"""
import argparse
import json
import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(coordinator, nprocs, pid, devices, batches, batch):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import time

    import numpy as np
    if nprocs > 1:
        from ldpc_tpu.parallel import init_distributed
        init_distributed(coordinator, nprocs, pid)
    from ldpc_tpu.config import (ChannelConfig, CodeConfig, DecoderConfig,
                                 QuantConfig, RunConfig, SimConfig)
    from ldpc_tpu.parallel import make_mesh
    from ldpc_tpu.sim import build_code, make_run_batch

    cfg = SimConfig(
        code=CodeConfig(family="ieee80211n", n=648, rate="1/2"),
        channel=ChannelConfig(modulation="bpsk"),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=DecoderConfig(algorithm="min-sum", schedule="flooding",
                              max_iter=8, early_term=False),
        run=RunConfig(batch=batch, seed=0),
    )
    code = build_code(cfg)
    if nprocs > 1:
        mesh = make_mesh(shape=(nprocs, devices), axes=("dcn", "ici"))
    else:
        mesh = make_mesh()
    rb = make_run_batch(code, cfg, mesh=mesh, decoder_backend="jnp")
    key = jax.random.PRNGKey(0)
    sig = np.float32(0.8)
    int(np.asarray(rb(key, sig))[0])  # compile + warm
    t0 = time.time()
    for i in range(batches):
        out = rb(jax.random.fold_in(key, i), sig)
    int(np.asarray(out)[0])  # fetch = sync
    dt = time.time() - t0
    print(f"RESULT {pid} {json.dumps({'frames_per_s': batch * batches / dt})}",
          flush=True)


def run_config(nprocs, devices, batches, batch):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", coord,
         str(nprocs), str(pid), str(devices), str(batches), str(batch)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(nprocs)]
    fps = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, f"child failed:\n{out}"
        m = re.search(r"RESULT \d+ (\{.*\})", out)
        fps.append(json.loads(m.group(1))["frames_per_s"])
    # each process pushes the full GLOBAL batch through its shard; global
    # throughput is the slowest process's rate (they run the same program)
    return min(fps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", nargs=6, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--devices", type=int, default=2,
                    help="fake devices per process")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch", type=int, default=512)
    args = ap.parse_args()
    if args.child:
        coord, nprocs, pid, devices, batches, batch = args.child
        child(coord, int(nprocs), int(pid), int(devices), int(batches),
              int(batch))
        return
    t1 = run_config(1, args.devices, args.batches, args.batch)
    tn = run_config(args.num_processes, args.devices, args.batches,
                    args.batch)
    # Perfect scaling doubles global frames/s per doubling of devices:
    # efficiency = tn / (N * t1). On shared-core CPU expect ~1/N (the N
    # processes time-slice the same silicon) — the harness demonstrates the
    # launch path; the real number needs real hosts.
    eff = tn / (args.num_processes * t1)
    print(json.dumps({
        "throughput_1proc_fps": round(t1, 1),
        f"throughput_{args.num_processes}proc_fps": round(tn, 1),
        "scaling_efficiency": round(eff, 3),
        "note": "CPU fake-device config shares physical cores across "
                "processes; on separate hosts only the 5-counter psum "
                "crosses DCN",
    }))


if __name__ == "__main__":
    main()
