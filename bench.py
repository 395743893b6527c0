"""Headline benchmark: aggregate IQ throughput of the full PHY stream loopback.

The flagship config, the reference's documented compute wall, the top
verified DECT rate, and a PCC-first latency breakdown:

  flagship   u=1 b=16 SISO MCS4, 2 packets at random offsets in a ~4x
             packet-length stream (multi-peak sync; ~50% duty cycle)
  wall       u=1 b=8 N_TX=4 TxDiv MCS2 with the 10/9 resampler IN the RX
             path (reference README.md:224-226: beta>=8 AND N_TX>=4 AND
             resampling overruns its sync on x86)
  u8b16      u=8 b=16 SISO at batch 128 (221.184 Ms/s DECT rate, the top
             verified rate, phy_config.cpp:32-67)
  latency    batch-1 sync->work_pcc and sync->tb_ok, host-inclusive
             single-shot AND device-side (reference headline: <250 us
             end-to-end, README.md:9)

Each pipeline is the reference's actual hot path: TX synthesis -> scatter
into a continuous stream -> AWGN -> [resample] -> sync search -> stream
slice + CFO derotation -> RX demod/decode (blind PCC + PDC turbo), mirroring
sync_chunk.cpp:146-278 feeding rx_synced.cpp:186-436, which sustains 1x real
time per channel on a tuned x86 host -- so vs_baseline == realtime multiple.

Runs on a GPU only (exits non-zero otherwise). Prints the device line,
then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from dectnrp_tpu.sections.part3.packet_sizes import get_packet_sizes


def _run_cell(cell, iters):
    import jax

    # correctness gate at the config's SNR
    ok_frac, det_frac = cell.gate(cell.step(*cell.args(0)))
    if ok_frac < 0.95 or det_frac < 0.95:
        return {"config": cell.name, "error": f"gate failed ok={ok_frac:.3f} "
                                              f"det={det_frac:.3f}"}
    jax.block_until_ready(cell.step(*cell.args(0)))
    t0 = time.perf_counter()
    for i in range(iters):
        out = cell.step(*cell.args(i + 1))
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    sps = cell.B * iters * cell.T_hw / dt
    rt = sps / cell.hw_rate
    return {
        "config": cell.name,
        "psdef": str(cell.psdef),
        "hw_rate_hz": cell.hw_rate,
        "resampler_in_rx_path": bool(cell.resample),
        "n_rx_ant": get_packet_sizes(cell.psdef).tm_mode.N_TX,
        "packets_per_stream": cell.n_pkts,
        "stream_len": cell.T_hw, "packet_len_hw": cell.n_pkt_hw,
        "duty_cycle": round(cell.n_pkts * cell.n_pkt_hw / cell.T_hw, 3),
        "batch": cell.B, "iters": iters, "gate_snr_db": cell.snr_db,
        "samples_per_s": round(sps),
        "realtime_multiple": round(rt, 3),
        "decode_ok_frac": ok_frac,
    }


def _host_ms(f, args, reps: int = 10) -> float:
    """Median single-shot wall time incl. the result fetch: the
    host-inclusive latency of one dispatch->compute->readback round trip."""
    _fetch(f(*args))                               # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _fetch(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _fetch(y):
    """Copy every leaf of y to host memory (waits for the device)."""
    import jax
    return jax.tree_util.tree_map(np.asarray, y)


def _latency_breakdown(psdef_f, nid) -> dict:
    """Batch-1 sync->work_pcc and sync->tb_ok: host-inclusive single shot
    (result copied to the host) and device-side (median per-call wall time
    to completion with block_until_ready, inputs already on the device).
    """
    import jax
    import jax.numpy as jnp

    from dectnrp_tpu.common.benchtime import median_ms
    from dectnrp_tpu.phy.sync import build_rx_stream, build_sync
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu.sections.part3.packet_sizes import get_packet_sizes
    from dectnrp_tpu.sections.part3.transmission_packet_structure import \
        get_N_samples_STF
    from dectnrp_tpu.upper.runtime import _min_len_psdef

    u, b = psdef_f.u, psdef_f.b
    ps_f = get_packet_sizes(psdef_f)
    ps_min = _min_len_psdef(u, b, psdef_f.tm_mode_index)
    n_min = get_packet_sizes(ps_min).N_samples_packet
    n_pkt = ps_f.N_samples_packet
    off = 4 * get_N_samples_STF(u, b)                      # sync chunk overlap
    T_pcc = n_min + off + 512                              # STF+PCC window
    T_full = n_pkt + off + 512

    sync_s = build_sync(u, b, T_pcc)
    rx_min = build_rx_stream(ps_min, nid, 1, T_pcc)
    rx_full = build_rx_stream(psdef_f, nid, 1, T_full)

    @jax.jit
    def pcc_first(y):
        rep = sync_s(y[..., :T_pcc])
        out = rx_min(y[..., :T_pcc], rep["t_fine"], rep["cfo"],
                     jnp.float32(10.0 ** -1.5))
        return out["plcf1_ok"], rep["t_fine"], rep["cfo"]

    @jax.jit
    def pdc_stage(y, t0, cfo):
        return rx_full(y, t0, cfo, jnp.float32(10.0 ** -1.5))["tb_ok"]

    # one packet at offset `off` in noise, batch 1
    rng = np.random.default_rng(3)
    tx = build_tx(psdef_f, nid, 1)
    plcf1 = jnp.asarray(rng.integers(0, 2, (1, 40)), jnp.uint8)
    tb1 = jnp.asarray(rng.integers(0, 2, (1, ps_f.N_TB_bits)), jnp.uint8)
    n_tx_ant = get_packet_sizes(psdef_f).tm_mode.N_TX

    @jax.jit
    def make_probe(plcf_b, tb_b, key):
        fl = jnp.zeros((1,), bool)
        iq = tx(plcf_b, tb_b, fl, fl)
        nvel = jnp.sqrt(jnp.float32(10.0 ** -1.5) / 2)
        k1, k2 = jax.random.split(key)
        noise = nvel * (
            jax.random.normal(k1, (1, n_tx_ant, T_full))
            + 1j * jax.random.normal(k2, (1, n_tx_ant, T_full))
        ).astype(jnp.complex64)
        return noise.at[..., off:off + n_pkt].add(iq)

    y = make_probe(plcf1, tb1, jax.random.PRNGKey(0))

    ok, t0s, cfos = pcc_first(y)
    if not bool(np.asarray(ok)[0]):
        return {"config": f"latency_b1_u{u}b{b}",
                "error": "latency probe: PLCF decode failed"}
    tb_ok = pdc_stage(y, t0s, cfos)
    if not bool(np.asarray(tb_ok)[0]):
        return {"config": f"latency_b1_u{u}b{b}",
                "error": "latency probe: TB decode failed"}

    pcc_host = _host_ms(pcc_first, (y,))
    pdc_host = _host_ms(pdc_stage, (y, t0s, cfos))
    pcc_dev = median_ms(pcc_first, y, iters=20)
    pdc_dev = median_ms(pdc_stage, y, t0s, cfos, iters=20)
    return {
        "config": f"latency_b1_u{u}b{b}",
        "sync_to_pcc_ms_host": round(pcc_host, 3),
        "sync_to_tb_ok_ms_host": round(pcc_host + pdc_host, 3),
        "sync_to_pcc_ms_device_marginal": round(pcc_dev, 3),
        "sync_to_tb_ok_ms_device_marginal": round(pcc_dev + pdc_dev, 3),
        "pcc_window_samples": T_pcc, "packet_samples": n_pkt,
        "note": "host = one dispatch+compute+readback round trip; "
                "device_marginal = median per-call wall time to completion "
                "(block_until_ready) with the inputs on the device; quote "
                "it against the reference's <250 us x86 headline "
                "(README.md:9).",
    }


def main() -> int:
    from dectnrp_tpu.common.jax_cache import enable_compile_cache
    enable_compile_cache()
    import jax

    from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef
    from dectnrp_tpu.simulation.stream_loop import StreamCell

    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (backend {jax.default_backend()!r}); "
              "the benchmark measures the card only", file=sys.stderr)
        return 2
    devs = jax.devices()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device_kind": devs[0].device_kind,
                      "device_count": len(devs), "nvidia_smi": smi}),
          flush=True)
    nid = 0x12345678
    iters = 10
    details = []

    # --- flagship: u=1 b=16 SISO MCS4, 2 packets per ~4x stream
    psdef_f = PacketSizesDef(1, 16, 1, 4, 0, 4, 6144)
    r_flag = _run_cell(StreamCell("flagship_u1b16_siso_mcs4", psdef_f, 4, 2,
                                  False, 64, 1_728_000 * 16, nid=nid), iters)
    details.append(r_flag)

    # --- the reference's compute wall: b=8, N_TX=4 TxDiv, resampler in RX;
    # gate at 20 dB: the MCS2 4-TS TxDiv waterfall sits right at 15 dB
    # (the wall is a COMPUTE case, reference README.md:224-226)
    details.append(_run_cell(StreamCell(
        "wall_b8_ntx4_resampled_mcs2", PacketSizesDef(1, 8, 1, 4, 5, 2, 6144),
        3, 1, True, 16, 1_728_000 * 8, snr_db=20.0, nid=nid), iters))

    # --- top verified rate: u=8 b=16 (221.184 Ms/s DECT rate) at batch 128
    details.append(_run_cell(StreamCell(
        "u8b16_siso_mcs4", PacketSizesDef(8, 16, 1, 1, 0, 4, 6144), 2, 1,
        False, 128, 1_728_000 * 8 * 16, nid=nid), iters))

    # --- per-stream latency at batch=1: PCC-first two-stage breakdown
    # (reference headline <250 us sync->decode, README.md:9; the runtime's
    # streaming shape is worker_tx_rx.cpp:110-228: work_pcc fires after the
    # PCC symbols, PDC when the declared length has arrived)
    details.append(_latency_breakdown(psdef_f, nid))

    err = next((d for d in details if "error" in d), None)
    val = 0.0 if err or "realtime_multiple" not in r_flag else \
        r_flag["realtime_multiple"]
    out = {
        "metric": "loopback_stream_realtime_multiple",
        "value": val,
        "unit": "x_realtime",
        "vs_baseline": val,
        "detail": {"platform": devs[0].platform, "configs": details},
    }
    if err:
        out["error"] = f"{err['config']}: {err['error']}"
    print(json.dumps(out))
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())
