"""FEC AWGN oracle with HARQ retransmissions (reference analog:
lib/src/phy/fec/test/tb2pdc_awgn.cpp:39-56).

MCS 0..9 x SNR -15..25 dB (2 dB step) x HARQ retx 0..3 (rv sequence
0,2,3,1, tb2pdc_awgn.cpp:216-228) x N packets. Pipeline per transmission:
TB -> pdc_encode(rv) -> MCS constellation map -> AWGN -> soft demap ->
d-domain de-rate-match -> chase/IR combine into the softbuffer ->
turbo decode -> TB CRC. Measures uncoded BER (hard decisions on coded bits
over all transmissions) and PER after each cumulative retransmission.

All device work happens in one jit per MCS; complex symbols never cross the
host boundary. Writes results/fec_awgn/fec_awgn_MCS_<m>.json.

Usage: python tools/run_fec_awgn.py [--n 20] [--mcs-max 9] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RV_SEQ = (0, 2, 3, 1)          # tb2pdc_awgn.cpp:216-228
NID = 123456789                # tb2pdc_awgn.cpp network_id


def _build_step(psdef, n_retx_max: int):
    import jax
    import jax.numpy as jnp

    from dectnrp_tpu.phy.fec.chain import PdcPlan, pdc_dematch, pdc_decode_d, \
        pdc_encode
    from dectnrp_tpu.phy.modulation import demap_llr, map_bits
    from dectnrp_tpu.sections.part3.packet_sizes import get_packet_sizes

    ps = get_packet_sizes(psdef)
    plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
    n_bps = ps.mcs.N_bps

    @jax.jit
    def step(tb, key, snr_db):
        """tb [B, N_TB] -> (tb_ok [B, n_retx_max+1], uncoded_errs [])"""
        nv = 10.0 ** (-snr_db / 10.0)
        soft = None
        oks = []
        errs = jnp.zeros((), jnp.int32)
        for t in range(n_retx_max + 1):
            rv = RV_SEQ[t]
            e = pdc_encode(tb, plan, NID, 1, rv=rv)            # [B, G] bits
            sym = map_bits(e, n_bps)                           # [B, G/n_bps]
            k1, k2 = jax.random.split(jax.random.fold_in(key, t))
            n = (jax.random.normal(k1, sym.shape)
                 + 1j * jax.random.normal(k2, sym.shape))
            y = sym + jnp.sqrt(nv / 2.0) * n.astype(jnp.complex64)
            llr = demap_llr(y, jnp.ones_like(sym.real), n_bps, nv)  # [B, G]
            errs = errs + jnp.sum((llr > 0).astype(jnp.uint8) != e)
            d_new = pdc_dematch(llr, plan, NID, 1, rv=rv)
            soft = d_new if soft is None else \
                {k: soft[k] + d_new[k] for k in d_new}
            bits, ok = pdc_decode_d(soft, plan)
            oks.append(ok)
        return jnp.stack(oks, axis=-1), errs

    return step, ps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--mcs-min", type=int, default=0)
    ap.add_argument("--mcs-max", type=int, default=9)
    ap.add_argument("--snr", type=float, nargs=3, default=(-15.0, 25.0, 2.0),
                    metavar=("MIN", "MAX", "STEP"))
    ap.add_argument("--retx", type=int, default=3)
    ap.add_argument("--out", default="results/fec_awgn")
    args = ap.parse_args()

    from dectnrp_tpu.common.jax_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, \
        get_packet_sizes

    platform = jax.devices()[0].platform
    snrs = np.arange(args.snr[0], args.snr[1] + 1e-9, args.snr[2])
    os.makedirs(args.out, exist_ok=True)
    t00 = time.perf_counter()

    for mcs in range(args.mcs_min, args.mcs_max + 1):
        psdef = PacketSizesDef(1, 1, 0, 4, 0, mcs, 6144)
        ps = get_packet_sizes(psdef)
        if ps is None:
            continue
        step, ps = _build_step(psdef, args.retx)
        rng = np.random.default_rng(1234 + mcs)
        ber, per = [], [[] for _ in range(args.retx + 1)]
        t0 = time.perf_counter()
        for i, snr in enumerate(snrs):
            tb = jnp.asarray(rng.integers(0, 2, (args.n, ps.N_TB_bits)),
                             jnp.uint8)
            oks, errs = step(tb, jax.random.PRNGKey(100 * mcs + i),
                             jnp.float32(snr))
            oks = np.asarray(oks)
            ber.append(float(np.asarray(errs))
                       / (ps.G * args.n * (args.retx + 1)))
            for t in range(args.retx + 1):
                per[t].append(1.0 - float(oks[:, t].mean()))
        rec = {
            "experiment_range": {"snr_vec": [float(s) for s in snrs],
                                 "nof_packets_per_snr": args.n,
                                 "rv_sequence": list(RV_SEQ[:args.retx + 1])},
            "parameter": {"mcs": mcs, "N_TB_bits": ps.N_TB_bits, "G": ps.G,
                          "N_bps": ps.mcs.N_bps,
                          "psdef": "u=1 b=1 type0 len4"},
            "result": {"BER_uncoded_vec": ber,
                       **{f"PER_retx{t}": per[t]
                          for t in range(args.retx + 1)}},
            "platform": platform,
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        p = os.path.join(args.out, f"fec_awgn_MCS_{mcs:02d}.json")
        with open(p, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"mcs {mcs}: BER@0dB={ber[len(ber)//2]:.4f} "
              f"PER_retx0 {per[0][len(ber)//2]:.2f} -> "
              f"retx{args.retx} {per[args.retx][len(ber)//2]:.2f} "
              f"({rec['wall_s']}s)", flush=True)

    meta = {"platform": platform,
            "total_wall_s": round(time.perf_counter() - t00, 1)}
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


if __name__ == "__main__":
    main()
