"""On-card smoke test: the PHY stream loop and the served p2p path on a GPU.

    python chip_smoke.py               # every phase, one GPU
    python chip_smoke.py --four-gpus   # only the sharded path, 4 GPUs

Each phase prints one JSON line with the card's name and power limit (as
nvidia-smi reports them), its wall time, its compile time and its own
gates. The last line is {"ok": true, "device": {...}} only if every phase
passed; any failed phase or gate exits non-zero without it. Without a GPU
the script exits non-zero before any phase runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from functools import partial
from pathlib import Path

import numpy as np

GATE = 0.95


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().replace("\n", " | ")


def _compile(f, *args):
    """(compiled f, compile seconds) for these argument shapes."""
    t0 = time.perf_counter()
    c = f.lower(*args).compile()
    return c, time.perf_counter() - t0


# ------------------------------------------------------------ stream phases

def _cell(name):
    from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef
    from dectnrp_tpu.simulation.stream_loop import StreamCell
    if name == "flagship":
        return StreamCell(name, PacketSizesDef(1, 16, 1, 4, 0, 4, 6144), 4, 2,
                          False, 64, 1_728_000 * 16)
    if name == "wall_resampled":
        # 20 dB: the MCS2 4-TS TxDiv waterfall sits right at 15 dB
        return StreamCell(name, PacketSizesDef(1, 8, 1, 4, 5, 2, 6144), 3, 1,
                          True, 16, 1_728_000 * 8, snr_db=20.0)
    return StreamCell(name, PacketSizesDef(8, 16, 1, 1, 0, 4, 6144), 2, 1,
                      False, 128, 1_728_000 * 8 * 16)


def _run_cell(cell, iters=5):
    from dectnrp_tpu.common.benchtime import timed_ms
    args = cell.args(0)
    step, comp_s = _compile(cell.step, *args)
    out = step(*args)
    ok, det = cell.gate(out)
    ms = timed_ms(step, *cell.args(1), iters=iters)
    rec = {"config": str(cell.psdef), "batch": cell.B,
           "packets_per_stream": cell.n_pkts, "snr_db": cell.snr_db,
           "tb_ok": ok, "detected": det, "compile_s": comp_s,
           "step_ms_median": float(np.median(ms)), "step_ms": ms,
           "realtime_multiple": cell.B * cell.T_hw / cell.hw_rate
           / (float(np.median(ms)) * 1e-3),
           "ok": ok >= GATE and det >= GATE}
    return rec, out


def _assert_gpu_bcjr(step_lowered_text: str) -> dict:
    """The engine _resolve_bcjr picks is the compiled GPU kernel."""
    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_gpu_cm
    from dectnrp_tpu.phy.fec.turbo_jax import _resolve_bcjr
    kind, fn = _resolve_bcjr(6144, None, "auto")
    chosen = getattr(fn, "func", None) is bcjr_posterior_gpu_cm
    interp = fn.keywords.get("interpret") if chosen else None
    in_hlo = "xla.gpu.triton" in step_lowered_text
    return {"bcjr_engine": "gpu" if chosen else "xla",
            "bcjr_interpret": interp, "triton_call_in_step": in_hlo,
            "bcjr_ok": bool(chosen and interp is False and in_hlo)}


def phase_stream_flagship(ctx):
    cell = _cell("flagship")
    rec, out = _run_cell(cell)
    eng = _assert_gpu_bcjr(cell.step.lower(*cell.args(0)).as_text())
    rec.update(eng)
    rec["ok"] = rec["ok"] and eng["bcjr_ok"]
    ctx["flagship"] = out
    return rec


def phase_stream_wall_resampled(ctx):
    rec, out = _run_cell(_cell("wall_resampled"))
    ctx["wall_resampled"] = out
    return rec


def phase_stream_u8b16(ctx):
    rec, _ = _run_cell(_cell("u8b16"))
    ctx["u8b16_step_ms"] = rec["step_ms_median"]
    return rec


# ------------------------------------------------------------ BCJR kernel

@contextmanager
def xla_bcjr():
    """Resolve every "auto" BCJR selection to the XLA engine (fresh traces),
    to time the stream loop without the kernel."""
    import jax

    from dectnrp_tpu.phy.fec import turbo_jax
    orig = turbo_jax._resolve_bcjr

    def forced(K, window, impl):
        return orig(K, window, "xla" if impl == "auto" else impl)
    jax.clear_caches()
    turbo_jax._resolve_bcjr = forced
    try:
        yield
    finally:
        turbo_jax._resolve_bcjr = orig
        jax.clear_caches()


def _noisy_codewords(K, B, sigma, seed):
    import jax.numpy as jnp

    from dectnrp_tpu.phy.fec.turbo_jax import turbo_encode
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.asarray(turbo_encode(jnp.asarray(c), K))
    x = 2.0 * d - 1.0
    y = x + sigma * rng.standard_normal(x.shape)
    return c, jnp.asarray((2.0 / sigma ** 2 * y).astype(np.float32))


def phase_bcjr_kernel(ctx):
    import jax
    import jax.numpy as jnp

    from dectnrp_tpu.common.benchtime import median_ms
    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_gpu_cm
    from dectnrp_tpu.phy.fec.crc import POLY_CRC24B, crc_matrix
    from dectnrp_tpu.phy.fec.turbo_jax import (_bcjr_posterior,
                                               _bcjr_posterior_windowed,
                                               turbo_decode_early)
    K = 6144
    rec, ok = {"K": K}, True
    kern = jax.jit(lambda s, p: bcjr_posterior_gpu_cm(s, p, K))
    # the reference on the kernel's column-major layout (a-priori folded in)
    ref = jax.jit(lambda s, p: _bcjr_posterior_windowed(
        s.T, p.T, jnp.zeros((s.shape[1], K), s.dtype), K).T)
    for B in (1100, 4096):      # >= 1024 columns, 1100 not a tile multiple
        rng = np.random.default_rng(B)
        ls = jnp.asarray(rng.standard_normal((K + 3, B), np.float32) * 3)
        lp = jnp.asarray(rng.standard_normal((K + 3, B), np.float32) * 3)
        kc, kcs = _compile(kern, ls, lp)
        rc, rcs = _compile(ref, ls, lp)
        got, want = np.asarray(kc(ls, lp)), np.asarray(rc(ls, lp))
        close = bool(np.allclose(got, want, rtol=1e-4, atol=1e-3))
        ok &= close
        rec[f"B{B}"] = {
            "allclose": close, "max_abs_diff": float(np.abs(got - want).max()),
            "gpu_ms": median_ms(kc, ls, lp), "xla_ms": median_ms(rc, ls, lp),
            "gpu_compile_s": kcs, "xla_compile_s": rcs}

    # full early-stopping decode with each engine: identical hard bits
    B = 1024
    c, llr = _noisy_codewords(K, B, 0.9, 3)
    m = jnp.asarray(crc_matrix(K - 24, POLY_CRC24B))
    bits = {}
    for impl in ("gpu", "xla"):
        f = jax.jit(lambda x, impl=impl: turbo_decode_early(
            x, m, K, n_iter_max=8, n_iter_min=2, impl=impl))
        fc, cs = _compile(f, llr)
        out = fc(llr)
        bits[impl] = np.asarray(out[0])
        rec[f"decode_{impl}"] = {"ms": median_ms(fc, llr, iters=5),
                                 "compile_s": cs, "n_it": int(out[3]),
                                 "bit_err_rate": float(
                                     (bits[impl] != c).mean())}
    same = bool(np.array_equal(bits["gpu"], bits["xla"]))
    rec["decode_bits_identical"] = same
    ok &= same

    # leading-axis flip at batch >= 576, K=6144: full-length BCJR on the
    # card against the same function on the host CPU
    B = 600
    rng = np.random.default_rng(11)
    args = [rng.standard_normal((B, K + 3), np.float32) * 3,
            rng.standard_normal((B, K + 3), np.float32) * 3,
            rng.standard_normal((B, K), np.float32)]
    full = partial(_bcjr_posterior, K=K)
    g = np.asarray(jax.jit(full)(*[jnp.asarray(a) for a in args]))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        h = np.asarray(jax.jit(full)(*[jax.device_put(a, cpu)
                                       for a in args]))
    flip_ok = bool(np.allclose(g, h, rtol=1e-4, atol=1e-3))
    rec["full_bcjr_flip_b600"] = {"allclose_vs_cpu": flip_ok,
                                  "max_abs_diff": float(np.abs(g - h).max())}
    ok &= flip_ok

    # end to end: stream_u8b16 with the XLA engine forced, beside the
    # kernel's step time from phase stream_u8b16
    with xla_bcjr():
        r, _ = _run_cell(_cell("u8b16"), iters=3)
    rec["e2e_u8b16"] = {
        "gpu": {"step_ms_median": ctx.get("u8b16_step_ms")},
        "xla": {"step_ms_median": r["step_ms_median"], "tb_ok": r["tb_ok"],
                "compile_s": r["compile_s"]}}
    rec["ok"] = bool(ok)
    return rec


# ------------------------------------------------------------ GF(2), complex

def phase_gf2_exact(ctx):
    import jax.numpy as jnp

    from dectnrp_tpu.phy.fec import turbo_np
    from dectnrp_tpu.phy.fec.chain import _crc_device
    from dectnrp_tpu.phy.fec.crc import POLY_CRC24B, crc_bits, crc_matrix
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_decode_early, turbo_encode
    K, B = 6144, 1024
    rng = np.random.default_rng(5)
    c = rng.integers(0, 2, (B, K)).astype(np.uint8)
    got = np.asarray(turbo_encode(jnp.asarray(c), K))
    want = np.stack([turbo_np.turbo_encode(row) for row in c])
    enc_ok = bool(np.array_equal(got, want))

    M = crc_matrix(K - 24, POLY_CRC24B)
    crc_dev = np.asarray(_crc_device(jnp.asarray(c[:, :K - 24]), M))
    crc_ref = np.stack([crc_bits(row, POLY_CRC24B) for row in c[:, :K - 24]])
    crc_ok = bool(np.array_equal(crc_dev, crc_ref))

    # syndrome inside the early-stopping decode: clean codewords whose
    # last 24 bits are the payload's CRC pass, the raw random ones fail
    cw = c.copy()
    cw[:, K - 24:] = crc_ref
    both = np.concatenate([cw[:B // 2], c[B // 2:]])
    d = np.asarray(turbo_encode(jnp.asarray(both), K)).astype(np.float32)
    llr = jnp.asarray(8.0 * d - 4.0)
    _, _, ok, _ = turbo_decode_early(llr, jnp.asarray(M), K, n_iter_max=2,
                                     n_iter_min=2)
    ok = np.asarray(ok)
    syn_ok = bool(ok[:B // 2].all() and not ok[B // 2:].any())
    return {"K": K, "B": B, "encoder_bit_exact": enc_ok,
            "crc_device_bit_exact": crc_ok, "decode_syndrome_exact": syn_ok,
            "ok": enc_ok and crc_ok and syn_ok}


def phase_complex_boundary(ctx):
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 1 << 20))
         + 1j * rng.standard_normal((4, 1 << 20))).astype(np.complex64)
    dx = jax.device_put(x)
    f = jax.jit(lambda z: z * jnp.exp(0.3j).astype(jnp.complex64)
                + jnp.conj(z))
    y = np.asarray(f(dx))
    y2 = np.asarray(f(x))                    # implicit host -> device put
    want = x * np.complex64(np.exp(0.3j)) + np.conj(x)
    ok = (y.dtype == np.complex64 and dx.dtype == jnp.complex64
          and np.allclose(y, want, atol=1e-5) and np.array_equal(y, y2)
          and np.array_equal(np.asarray(dx), x))
    return {"shape": list(x.shape), "ok": bool(ok)}


# ------------------------------------------------------------ served path

def phase_served_p2p(ctx):
    from dectnrp_tpu.config import build_scenario, load_scenario
    from dectnrp_tpu.upper.exchange import (run_mimo_exchange,
                                            run_per_point,
                                            run_two_node_exchange)
    sc = load_scenario(Path(__file__).resolve().parent
                       / "configurations" / "p2p_simulator")
    run = build_scenario(sc)
    tick_ms = []
    for _ in range(120):
        t0 = time.perf_counter()
        run.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    ft, pt = run.firmwares
    rt_pt = run.runtimes[1]
    p2p = {"ticks": len(tick_ms),
           "tick_ms_median": float(np.median(tick_ms)),
           "tick_ms_max": float(max(tick_ms)),
           "pt_runtime": vars(rt_pt.stats), "ft_runtime":
           vars(run.runtimes[0].stats), "pt_firmware": pt.stats,
           "ft_firmware": ft.stats}
    p2p["ok"] = bool(pt.stats["beacons"] >= 2 and rt_pt.stats.pcc_ok > 0
                     and rt_pt.stats.pdc_ok > 0)
    run.close()
    rec = {"p2p_simulator": p2p,
           "p2p_dect_rate": run_two_node_exchange(),
           "p2p_mimo_nss2": run_mimo_exchange(),
           "per_point_15db": run_per_point(15.0)}
    rec["ok"] = all(v["ok"] for v in rec.values())
    return rec


# ------------------------------------------------------------ precision

def phase_precision(ctx):
    import jax

    from dectnrp_tpu.phy.modulation import hard_decision
    rec, ok = {}, True
    for name, n_bps in (("flagship", 4), ("wall_resampled", 2)):
        base = ctx.get(name)
        if base is None:
            raise RuntimeError(f"phase stream_{name} produced no output")
        with jax.default_matmul_precision("highest"):
            cell = _cell(name)
            hi, cs = _compile(cell.step, *cell.args(0))
            out = hi(*cell.args(0))
        x0, x1 = np.asarray(base[3]), np.asarray(out[3])
        rms = float(np.sqrt(np.mean(np.abs(x1) ** 2)))

        def evm(x):
            d = np.asarray(hard_decision(jax.numpy.asarray(x.reshape(
                -1, x.shape[-1])), n_bps)).reshape(x.shape)
            return float(10 * np.log10(np.mean(np.abs(x - d) ** 2)
                                       / np.mean(np.abs(d) ** 2)))
        r = {"x_pdc_max_abs_diff_over_rms":
             float(np.abs(x0 - x1).max()) / rms,
             "evm_db_default": evm(x0), "evm_db_highest": evm(x1),
             "tb_ok_default": float(np.asarray(base[0]).mean()),
             "tb_ok_highest": float(np.asarray(out[0]).mean()),
             "tb_ok_rows_differ": int((np.asarray(base[0])
                                       != np.asarray(out[0])).sum()),
             "t_fine_rows_differ": int((np.asarray(base[2])
                                        != np.asarray(out[2])).sum()),
             "compile_s": cs}
        rec[name] = r
        ok &= r["tb_ok_highest"] >= GATE and r["tb_ok_default"] >= GATE
    rec["ok"] = bool(ok)
    return rec


# ------------------------------------------------------------ four GPUs

def four_gpus():
    import jax

    from __graft_entry__ import dryrun_multichip
    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-gpus needs 4 devices, found {len(devs)}")
    t0 = time.perf_counter()
    sh = dryrun_multichip(4, devs[:4])
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = dryrun_multichip(4, devs[:1])
    t_one = time.perf_counter() - t0
    same_ok = bool(np.array_equal(sh["node_tb_ok"], one["node_tb_ok"]))
    tg = (len(sh["t_global"]) == len(one["t_global"]) and all(
        abs(a - b) <= 2 for a, b in zip(sh["t_global"], one["t_global"])))
    spread = (len(set(sh["devices_used"])) == 4
              and len(set(sh["sync_devices_used"])) == 4)
    return {"sharded": sh, "one_device": one,
            "sharded_wall_s": t_sh, "one_device_wall_s": t_one,
            "node_tb_ok_identical": same_ok, "t_global_within_2": bool(tg),
            "shards_on_4_devices": spread,
            "ok": bool(same_ok and tg and spread and sh["ok"] and one["ok"])}


PHASES = [
    ("stream_flagship", phase_stream_flagship),
    ("stream_wall_resampled", phase_stream_wall_resampled),
    ("stream_u8b16", phase_stream_u8b16),
    ("bcjr_kernel", phase_bcjr_kernel),
    ("gf2_exact", phase_gf2_exact),
    ("complex_boundary", phase_complex_boundary),
    ("served_p2p", phase_served_p2p),
    ("precision", phase_precision),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU sharded path and its "
                         "one-device comparison")
    a = ap.parse_args()

    from dectnrp_tpu.common.jax_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    phases = [("four_gpus", lambda ctx: four_gpus())] if a.four_gpus \
        else PHASES
    ctx, all_ok = {}, True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn(ctx)
        except Exception as e:       # report the phase as failed, go on
            traceback.print_exc()
            rec = {"ok": False, "error": repr(e)[:2000]}
        rec = {"phase": name, "card": card,
               "wall_s": time.perf_counter() - t0, **rec}
        print(json.dumps(rec, default=str), flush=True)
        all_ok &= bool(rec["ok"])
    if not all_ok:
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": 4 if a.four_gpus else len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
