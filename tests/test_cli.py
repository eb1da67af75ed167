"""CLI surface tests: argument parsing -> config resolution, presets/codes
listings, and report generation (the sweep path itself is covered by
tests/test_sim.py and the CPU smoke in CI use)."""
import json
import os

import pytest

from ldpc_tpu.cli import _parse_ebn0, build_parser, _build_config, cmd_report


def _cfg(argv):
    args = build_parser().parse_args(argv)
    return _build_config(args)


def test_parse_ebn0():
    assert _parse_ebn0("1.0:2.0:0.5") == [1.0, 1.5, 2.0]
    assert _parse_ebn0("2.5") == [2.5]
    assert _parse_ebn0("1,2.25,3") == [1.0, 2.25, 3.0]


def test_preset_resolution():
    cfg = _cfg(["sweep", "--preset", "wifi-648-r12-minsum"])
    assert cfg.code.n == 648 and cfg.decoder.algorithm == "min-sum"
    assert not cfg.decoder.early_term


def test_overrides_compose_with_preset():
    cfg = _cfg(["sweep", "--preset", "wifi-648-r12-minsum", "--n", "1296",
                "--algorithm", "offset-min-sum", "--schedule", "layered",
                "--beta-lsb", "3", "--batch", "2048", "--all-zeros"])
    assert cfg.code.n == 1296
    assert cfg.decoder.algorithm == "offset-min-sum"
    assert cfg.decoder.schedule == "layered"
    assert cfg.quant.beta_lsb == 3
    assert cfg.run.batch == 2048
    assert cfg.run.all_zeros


def test_nr_flags():
    cfg = _cfg(["sweep", "--family", "5gnr", "--base-graph", "2", "--Z", "64",
                "--rate", "1/3", "--k-info", "500"])
    assert cfg.code.family == "5gnr"
    assert cfg.code.base_graph == 2 and cfg.code.Z == 64
    assert cfg.code.k_info == 500


def test_config_roundtrip_json():
    cfg = _cfg(["config", "--preset", "dvbs2-64800-r12"])
    d = json.loads(cfg.to_json())
    assert d["code"]["family"] == "dvbs2"
    from ldpc_tpu.config import SimConfig
    assert SimConfig.from_json(cfg.to_json()) == cfg


def test_report_from_json(tmp_path):
    payload = {
        "config": {}, "code": "x", "k": 1, "n": 2, "decoder_backend": "jnp",
        "results": [
            {"ebn0_db": 1.0, "ber": 1e-2, "fer": 1e-1},
            {"ebn0_db": 2.0, "ber": 1e-4, "fer": 1e-3},
        ],
    }
    src = tmp_path / "r.json"
    src.write_text(json.dumps(payload))
    out = tmp_path / "out.png"

    class A:
        jsons = [str(src)]
        out = str(tmp_path / "out.png")
        metric = "ber"

    assert cmd_report(A) == 0
    assert (tmp_path / "out.png").exists()


def test_sweep_default_checkpoint_and_extension(tmp_path):
    """--out implies a <out>.state checkpoint (docs/USAGE.md contract);
    rerunning the same command with a LARGER --max-frames resumes and
    extends instead of starting over or refusing (stop rules are exempt
    from the resume config guard)."""
    from ldpc_tpu.cli import main
    out = str(tmp_path / "sw")
    base = ["sweep", "--preset", "wifi-648-r12-minsum", "--batch", "64",
            "--ebn0", "2.0", "--target-errors", "999999",
            "--decoder-backend", "jnp", "--out", out]
    assert main(base + ["--max-frames", "64"]) == 0
    assert os.path.exists(out + ".state")
    assert json.load(open(out + ".json"))["results"][0]["frames"] == 64
    assert main(base + ["--max-frames", "128"]) == 0
    assert json.load(open(out + ".json"))["results"][0]["frames"] == 128
    # --no-checkpoint opts out
    out2 = str(tmp_path / "nw")
    assert main(["sweep", "--preset", "wifi-648-r12-minsum", "--batch",
                 "64", "--ebn0", "2.0", "--max-frames", "64",
                 "--target-errors", "999999", "--decoder-backend", "jnp",
                 "--out", out2, "--no-checkpoint"]) == 0
    assert not os.path.exists(out2 + ".state")


def test_ebn0_zero_step_rejected():
    from ldpc_tpu.cli import _parse_ebn0
    with pytest.raises(ValueError, match="step"):
        _parse_ebn0("1.0:3.0:0")
    with pytest.raises(ValueError, match="step"):
        _parse_ebn0("1.0:3.0:-0.5")
    assert _parse_ebn0("1.0:2.0:0.5") == [1.0, 1.5, 2.0]


def test_write_outputs_creates_directory(tmp_path):
    from ldpc_tpu.sim.report import write_outputs
    from ldpc_tpu.sim.sweep import SweepResult
    from ldpc_tpu.sim.stats import SnrPoint
    from ldpc_tpu.config import PRESETS
    res = SweepResult(config=PRESETS["wifi-648-r12-minsum"], code_name="x",
                      k=324, n=648, points=[SnrPoint(ebn0_db=2.0)],
                      decoder_backend="jnp")
    prefix = str(tmp_path / "new" / "deep" / "run1")
    paths = write_outputs(res, prefix)
    import os
    assert all(os.path.exists(p) for p in paths)


def test_bench_workload_configs_build():
    """bench.py --all measures the extended workloads; their configs must
    stay constructible (code family, modulation divisibility are checked at
    build time)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    from ldpc_tpu.sim import build_code
    assert bench.CONFIG in bench.WORKLOADS
    for name, (batch, _, _) in bench.WORKLOADS.items():
        cfg = bench._cfg(name)
        code = build_code(cfg)
        assert batch % 128 == 0 and code.n > 0
        if cfg.channel.modulation != "bpsk":
            from ldpc_tpu.ops.channel import BITS_PER_SYM
            assert code.n % BITS_PER_SYM[cfg.channel.modulation] == 0


def test_bench_refuses_without_gpu():
    """On a machine without a GPU, bench.py exits non-zero with a message
    and measures nothing."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, os.path.join(root, "bench.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu",
                                  PYTHONPATH=root))
    assert res.returncode != 0
    assert "no GPU" in res.stderr and res.stdout == ""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    otherwise the fixed <repo>/.jax_cache."""
    import jax
    from ldpc_tpu.utils import cache
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            want = os.path.join(root, ".jax_cache")
            assert cache.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cli_auto_two_phase_implies_early_term():
    p = build_parser()
    args = p.parse_args(["sweep", "--preset", "wifi-648-r12-minsum",
                         "--auto-two-phase"])
    cfg = _build_config(args)
    assert cfg.decoder.phase1_iters == -1 and cfg.decoder.early_term
    args2 = p.parse_args(["sweep", "--preset", "wifi-648-r12-minsum",
                          "--auto-two-phase", "--no-early-term"])
    with pytest.raises(SystemExit):
        _build_config(args2)


def test_cli_analyze_de_threshold(capsys):
    """`analyze` exposes the DE layer on the CLI (the reference's MATLAB
    analysis role): AWGN threshold for the canonical code, JSON on stdout."""
    from ldpc_tpu.cli import cmd_analyze
    p = build_parser()
    args = p.parse_args(["analyze", "--family", "ieee80211n", "--n", "648",
                         "--rate", "1/2", "--algorithm", "offset-min-sum",
                         "--beta-lsb", "1", "--bracket", "0.6", "1.3",
                         "--iters", "60", "--tol", "1e-2"])
    assert cmd_analyze(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["channel"] == "awgn-bpsk"
    assert 0.188 < out["ebn0_star_db"] < 2.0  # Shannon < DE* < waterfall


def test_cli_analyze_pexit(capsys, tmp_path):
    """`analyze --pexit` drives the PEXIT screening leg end-to-end and can
    emit an EXIT-chart artifact; its float-SP threshold must sit between
    Shannon and the quantized OMS DE threshold (~0.82 dB)."""
    from ldpc_tpu.cli import main
    chart = str(tmp_path / "chart.json")
    rc = main(["analyze", "--family", "ieee80211n", "--n", "648",
               "--rate", "1/2", "--pexit", "--exit-chart", chart,
               "--tol", "5e-3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["method"].startswith("pexit")
    assert 0.18 < out["ebn0_star_db"] < 0.85
    d = json.load(open(chart))
    assert len(d["I_a"]) == len(d["I_ev"]) == len(d["I_ec_inv"]) > 100


def test_cli_analyze_minstar(capsys):
    """`analyze --algorithm min-star`: the min* DE threshold must beat the
    OMS one (closer to sum-product) — CLI-level pin of the family order."""
    from ldpc_tpu.cli import main
    # default iteration budget: min* converges more slowly per the pmf
    # recursion than OMS, so a trimmed budget inflates its threshold
    rc = main(["analyze", "--family", "ieee80211n", "--n", "648",
               "--rate", "1/2", "--algorithm", "min-star",
               "--bracket", "0.6", "1.3", "--tol", "5e-3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["algorithm"] == "min-star"
    assert 0.188 < out["ebn0_star_db"] < 0.82  # better than OMS's 0.816


def test_analyze_scan_scale(capsys):
    from ldpc_tpu.cli import main
    rc = main(["analyze", "--scan-scale", "3:6:2", "--beta-lsb", "2",
               "--algorithm", "offset-min-sum", "--bits", "8",
               "--iters", "60", "--tol", "5e-3"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip()
             .splitlines() if x.startswith("{")]
    assert "best_scale" in lines[-1]
    assert sum("sigma_star" in r for r in lines[:-1]) >= 1


def test_analyze_scan_scale_minstar(capsys):
    """--scan-scale re-derives the min* LUT per scale (round 5)."""
    from ldpc_tpu.cli import main
    rc = main(["analyze", "--scan-scale", "3:6:2", "--algorithm",
               "min-star", "--bits", "8", "--iters", "60",
               "--tol", "1e-2"])
    assert rc == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert len(lines) >= 2
    assert any("scale" in d and "sigma_star" in d for d in lines)
