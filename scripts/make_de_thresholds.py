"""Density-evolution threshold artifact (analysis/de.py, irregular spectra).

Computes quantized min-sum-family DE thresholds for the PRODUCTION irregular
degree profiles (VERDICT round-2 item 7) and cross-checks the 802.11n OMS
threshold directionally against the measured waterfall artifact
(results/cn_variants_oms_b1.json). Pure NumPy — no accelerator needed.

Usage: PYTHONPATH=. python scripts/make_de_thresholds.py [outdir]
"""
import json
import math
import sys
import time

from ldpc_tpu.analysis import de
from ldpc_tpu.config import QuantConfig


def ebn0_db(sigma: float, rate: float) -> float:
    return -20.0 * math.log10(sigma * math.sqrt(2.0 * rate))


def main() -> None:
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results"
    quant_ms = QuantConfig(bits=8, scale=4.0, beta_lsb=0)
    quant_oms = QuantConfig(bits=8, scale=4.0, beta_lsb=1)

    cases = []

    def add(name, code, label, beta, alpha, quant, bracket,
            target=1e-7, extra=None, minstar=None):
        t0 = time.time()
        sp = de.spectra_from_code(code)
        sigma = de.de_threshold_awgn_spectra(
            sp, quant, beta=beta, alpha=alpha, iters=120, tol=2e-3,
            bracket=bracket, target=target, minstar=minstar)
        rate = code.k / code.n
        row = {
            "code": name, "decoder": label, "rate": rate,
            "bits": quant.bits, "scale": quant.scale,
            "sigma_star": round(sigma, 4),
            "ebn0_star_db": round(ebn0_db(sigma, rate), 3),
            "pe_target": target,
            "max_dv": sp.max_dv, "max_dc": sp.max_dc,
            "wall_s": round(time.time() - t0, 1),
        }
        if extra:
            row.update(extra)
        cases.append(row)
        print(row)

    from ldpc_tpu.codes.ieee80211n import make_code as wifi

    w648 = wifi(648, "1/2")
    add("wifi648_r12", w648, "min-sum 8-bit", 0, None, quant_ms, (0.6, 1.3))
    add("wifi648_r12", w648, "oms beta=1 8-bit", 1, None, quant_oms,
        (0.6, 1.3))
    # min* (approx sum-product, threshold-LUT (8,3,0) at scale 4): the
    # round-5 family — must land at or below the OMS threshold (closer to
    # sum-product), the same order the silicon waterfall measures.
    from ldpc_tpu.config import minstar_thresholds
    add("wifi648_r12", w648, "min-star 8-bit", 0, None, quant_ms,
        (0.6, 1.3), minstar=minstar_thresholds(quant_ms),
        extra={"lut_thresholds": list(minstar_thresholds(quant_ms))})
    # Quantized NMS 3/4 has a genuine DE error FLOOR on this irregular
    # profile: the dyadic scaling maps magnitude 1 -> 0, and the degree-2-
    # heavy 802.11n spectrum reaches a nonzero fixed point (Pe ~8.6e-6 at
    # sigma=0.7) instead of converging to 0 — consistent with the measured
    # hardware curve (results/cn_variants_nms_a34.json: BER 1.2e-6 at
    # 3.0 dB where OMS keeps falling). Report the floor and a 1e-4-target
    # threshold instead of a misleading 1e-7 one.
    sp_w = de.spectra_from_code(w648)
    floor = de.de_pe_trajectory_spectra(
        de.chan_pmf_awgn(0.7, quant_ms), sp_w, beta=0, alpha=(3, 2),
        qmax=quant_ms.qmax, iters=400)[-1]
    add("wifi648_r12", w648, "nms 3/4 8-bit", 0, (3, 2), quant_ms,
        (0.6, 1.3), target=1e-4,
        extra={"pe_floor_sigma_0.7": float(f"{floor:.3g}"),
               "note": "quantized-NMS DE fixed point (mag 1 -> 0 under "
                       "(x*3)>>2); threshold quoted at Pe<=1e-4"})
    w34 = wifi(648, "3/4")
    add("wifi648_r34", w34, "oms beta=1 8-bit", 1, None, quant_oms,
        (0.5, 1.0))

    # NR / DVB-S2 profiles (round-3 extension). NR rows are MOTHER-code
    # thresholds: spectra_from_code uses the graph degree profile, the
    # iid-channel DE does not model the 2Z punctured columns' zero LLRs
    # (that needs multi-edge-type DE), and the decision average is
    # restricted to degrees >= 2 — NR's ~60% degree-1 extension parities
    # have an irreducible decision floor (chan + one saturating message)
    # while the info-carrying degrees converge. Labeled accordingly.
    quant_b2 = QuantConfig(bits=8, scale=4.0, beta_lsb=2)
    from ldpc_tpu.codes.dvbs2 import make_code as dvbs2
    from ldpc_tpu.codes.nr_bg import make_code as nrbg
    add("dvbs2_64800_r12", dvbs2(64800, "1/2"), "oms beta=2 8-bit", 2,
        None, quant_b2, (0.6, 1.3),
        extra={"note": "single-edge-type ensemble threshold of the lambda/"
                       "rho profile; PESSIMISTIC for the structured IRA "
                       "instance — the measured n=64800 waterfall "
                       "(results/dvbs2_64800_et: FER 0 at 1.25 dB) sits "
                       "~0.2 dB below it (structure gain needs multi-edge-"
                       "type DE to capture)"})

    def add_nr(name, code, bracket):
        t0 = time.time()
        sp = de.spectra_from_code(code)
        w = de.decision_weights_min_degree(sp, 2)
        # Even the degree->=2 decision average floors (~6e-6 at
        # sigma=0.6 for BG1): the degree-1 nodes keep feeding chan-only
        # v2c into the density, so Pe never reaches 1e-7 — a genuine
        # iid-ensemble property; the exact tool is multi-edge-type DE.
        # Quote the threshold at Pe<=1e-4 (NMS-row precedent).
        sigma = de.de_threshold_awgn_spectra(
            sp, quant_b2, beta=2, iters=160, tol=2e-3, bracket=bracket,
            target=1e-4, decision_vnode=w)
        rate = code.k / code.n
        row = {"code": name,
               "decoder": "oms beta=2 8-bit",
               "rate": rate, "bits": 8, "scale": 4.0,
               "sigma_star": round(sigma, 4),
               "ebn0_star_db": round(ebn0_db(sigma, rate), 3),
               "pe_target": 1e-4,
               "max_dv": sp.max_dv, "max_dc": sp.max_dc,
               "decision": "degrees >= 2 (info-carrying)",
               "note": "mother code; puncturing not modeled; degree-1 "
                       "extension parities excluded from the decision "
                       "average; residual density floor -> threshold "
                       "quoted at Pe<=1e-4",
               "wall_s": round(time.time() - t0, 1)}
        cases.append(row)
        print(row)

    add_nr("nr_bg1_z384_mother", nrbg(base_graph=1, Z=384), (0.6, 1.6))
    add_nr("nr_bg2_z128_mother", nrbg(base_graph=2, Z=128), (0.6, 1.8))

    # regular (3,6) reference row — shows the irregular gain explicitly
    t0 = time.time()
    sigma_reg = de.de_threshold_awgn_spectra(
        de.regular_spectra(3, 6), quant_oms, beta=1, iters=120, tol=2e-3,
        bracket=(0.6, 1.3))
    cases.append({
        "code": "regular_3_6", "decoder": "oms beta=1 8-bit", "rate": 0.5,
        "bits": 8, "scale": 4.0, "sigma_star": round(sigma_reg, 4),
        "ebn0_star_db": round(ebn0_db(sigma_reg, 0.5), 3),
        "max_dv": 3, "max_dc": 6, "wall_s": round(time.time() - t0, 1),
    })

    # Directional cross-check vs the measured waterfall artifact:
    # the asymptotic threshold must sit below the finite-length n=648
    # waterfall region (BER 1.1e-3 at 2.0 dB, 20 iters, layered OMS b=1).
    oms = next(c for c in cases if c["code"] == "wifi648_r12"
               and c["decoder"].startswith("oms"))
    check = {
        "artifact": "results/cn_variants_oms_b1.json",
        "waterfall_ebn0_db": 2.0,
        "waterfall_ber": 1.06e-3,
        "threshold_below_waterfall": oms["ebn0_star_db"] < 2.0,
        "threshold_above_shannon": oms["ebn0_star_db"] > 0.188,
    }
    assert check["threshold_below_waterfall"], oms
    assert check["threshold_above_shannon"], oms

    out = {"thresholds": cases, "waterfall_check": check,
           "notes": "AWGN BPSK, quantized min-sum-family DE over the codes' "
                    "actual edge-degree spectra (analysis/de.py); "
                    "Eb/N0* = -20 log10(sigma* sqrt(2R))."}
    path = f"{outdir}/de_thresholds.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
