"""Run the PER-vs-SNR oracle sweep and save reference-schema JSON curves.

Reference oracle: lib/src/upper/loopback/tfw_loopback_snr.cpp:34-187 —
MCS 1..6 x SNR -2..20 dB x 100 packets, one JSON per MCS. Two variants are
produced: "sync" (packets at random offsets in a stream, full sync search
before decode — the reference's actual signal path) and "aligned" (perfect
timing, isolates the FEC/demod waterfall).

Usage: python tools/run_loopback_snr.py [out_dir]
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    out_root = sys.argv[1] if len(sys.argv) > 1 else "results/loopback_snr"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else None
    from dectnrp_tpu.common.jax_cache import enable_compile_cache
    enable_compile_cache()
    from dectnrp_tpu.upper.loopback import LoopbackSnrExperiment

    variants = (
        ("sync", dict(use_sync=True)),
        ("aligned", dict(use_sync=False)),
        # doubly-selective fading (reference configurations/ default channel
        # "doubly_0_363_222"): PDP ITU Ped A, tau_rms 363 ns, f_D 222 Hz;
        # waterfalls shift right + error-floor vs AWGN
        ("fading", dict(use_sync=True, channel="doubly_0_363_222",
                        snr_db=tuple(float(s) for s in range(0, 31, 2)))),
        # diagnostic pair for the fading floor:
        # estimated-chestim vs TRUE-channel (genie) equalization, both
        # aligned — the gap between the two curves IS the channel-
        # estimation loss; outage would floor the genie curve too
        ("fading_aligned", dict(use_sync=False, channel="doubly_0_363_222",
                                snr_db=tuple(float(s) for s in range(0, 31, 2)))),
        ("fading_genie", dict(use_sync=False, channel="doubly_0_363_222",
                              genie=True,
                              snr_db=tuple(float(s) for s in range(0, 31, 2)))),
        # resampler pair in the loop: ~25 dB EVM floor
        # (resampler_param.hpp:70-88) — high-MCS floors appear
        ("resampled", dict(use_sync=True, resampler_loop=True)),
        # N_SS=2 spatial multiplexing (tm mode 2, 2x2) through the FULL
        # sync -> MMSE -> decode path: the capability the reference stubs
        # (rx_synced.cpp:1331-1333 run_pdc_mode_AxA_MIMO is a todo).
        # AWGN = identity 2x2 mixing; "mimo_fading" = doubly-selective
        # Rayleigh 2x2 (real spatial mixing, tau 363 ns, f_D 222 Hz)
        ("mimo", dict(use_sync=True, tm_mode_index=2,
                      mcs_list=(1, 2, 3, 4))),
        ("mimo_fading", dict(use_sync=True, tm_mode_index=2,
                             channel="doubly_0_363_222",
                             mcs_list=(1, 2, 4),
                             snr_db=tuple(float(s) for s in range(0, 37, 2)))),
    )
    meta = {}
    for name, kw in variants:
        t0 = time.perf_counter()
        if n is not None:
            kw = dict(kw, n_per_snr=n)
        exp = LoopbackSnrExperiment(**kw)
        paths = exp.save_json(os.path.join(out_root, name))
        dt = time.perf_counter() - t0
        meta[name] = {"files": [os.path.basename(p) for p in paths],
                      "wall_s": round(dt, 1),
                      "n_per_snr": exp.n_per_snr,
                      "snr_db": list(exp.snr_db),
                      "mcs": list(exp.mcs_list), **{k: v for k, v in kw.items()
                                                    if isinstance(v, (str, bool, int))}}
        print(f"{name}: {len(paths)} curves in {dt:.1f}s", flush=True)
    import jax
    meta["platform"] = jax.devices()[0].platform
    meta["fading_floor_note"] = (
        "r04 root-cause: genie-chestim runs decode with ZERO floor where the "
        "estimated path floored at 4-22% (MCS2/MCS4, 26 dB) -> the r03 fading "
        "floor was channel-ESTIMATION loss, not Rayleigh outage. Fixes: "
        "(1) SNR estimator uses 4th-order pilot differences so frequency "
        "selectivity no longer inflates the noise estimate (phy/rx.py), "
        "(2) Wiener presets follow the reference's triples (tau 0.1/0.1/1.0 "
        "us at SNR -5/15/35 dB) with REAL symmetric-uniform-PDP weights "
        "(phy/chestim.py), (3) preset selection gained a measured-"
        "selectivity axis (narrow vs wide delay window) beyond the "
        "reference's SNR-only pick (phy/rx.py). "
        "r05: the estimated-vs-genie gap shrank 12x -> 3.4-6.4x at "
        "20-28 dB: on SELECTIVE channels at mid/high SNR the wide "
        "uniform-PDP Wiener's prior bias dominated once pilot noise was "
        "small, so those preset slots now use clamped LINEAR frequency "
        "interpolation (locally unbiased). Measured NOT to help and "
        "documented: Jakes time-Wiener (nu) bank, tau-matched sinc-PDP "
        "Wiener, decision-directed re-estimation and DD per-symbol CPE "
        "(common phase already handled by the DRS-pair CFO refinement). "
        "The remaining gap is pilot noise inside fades.")
    with open(os.path.join(out_root, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


if __name__ == "__main__":
    main()
