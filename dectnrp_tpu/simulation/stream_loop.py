"""Batched PHY stream loop: the reference's hot path as one jitted step.

TX synthesis -> scatter into a continuous stream -> AWGN -> [10/9 resample
up at TX, 9/10 down at RX] -> STF sync search -> stream slice + CFO
derotation -> RX demod/chestim/equalise -> PDC turbo decode, mirroring
sync_chunk.cpp:146-278 feeding rx_synced.cpp:186-436. bench.py times it;
chip_smoke.py checks it on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..phy.resampler import ResamplerPlan, build_resampler
from ..phy.sync import build_rx_stream, build_sync
from ..phy.tx import build_tx
from ..sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .channels import awgn


def build_stream_step(psdef: PacketSizesDef, T: int, n_pkts: int,
                      resample: bool, nid: int, snr_db: float = 15.0):
    """Jitted step(plcf_bits, tb_bits, key, offsets) for one config.

    offsets [B, n_pkts] are hw-rate sample positions of the packets.
    Returns (step, T_hw, n_pkt_hw); step returns (tb_ok [B, n_pkts],
    detected [B, n_pkts], t_fine [B, n_pkts], x_pdc [B, n_pkts, n_cells])
    where x_pdc is the equalised PDC constellation.
    """
    n_pkt = get_packet_sizes(psdef).N_samples_packet
    tx = build_tx(psdef, nid, 1)
    if resample:
        up = build_resampler(ResamplerPlan(10, 9), n_pkt)      # dect -> sdr
        n_pkt_hw = -(-n_pkt * 10 // 9)
        T_hw = -(-T * 10 // 9) // 10 * 10                      # sdr stream len
        down = build_resampler(ResamplerPlan(9, 10), T_hw)     # sdr -> dect
        T_dect = -(-T_hw * 9 // 10)
    else:
        n_pkt_hw, T_hw, T_dect = n_pkt, T, T
    sync = build_sync(psdef.u, psdef.b, T_dect, max_peaks=n_pkts)
    rxs = build_rx_stream(psdef, nid, 1, T_dect)

    @jax.jit
    def step(plcf_bits, tb_bits, key, offsets):
        B = plcf_bits.shape[0]
        flags = jnp.zeros((B,), bool)
        iq = tx(plcf_bits, tb_bits, flags, flags)          # [B, NTX, n_pkt]
        if resample:
            iq = up(iq)                                    # [B, NTX, n_pkt_hw]

        def scatter(off, pkt):
            z = jnp.zeros((pkt.shape[0], T_hw), jnp.complex64)
            return jax.lax.dynamic_update_slice_in_dim(z, pkt, off, axis=-1)

        stream = sum(jax.vmap(scatter)(offsets[:, k], iq)
                     for k in range(n_pkts))
        nv = jnp.float32(10.0 ** (-snr_db / 10.0))
        y = awgn(key, stream, nv)
        if resample:
            y = down(y)                                    # [B, R, T_dect]
        rep = sync(y)
        tf = rep["t_fine"] if n_pkts > 1 else rep["t_fine"][:, None]
        cf = rep["cfo"] if n_pkts > 1 else rep["cfo"][:, None]
        det = rep["detected"] if n_pkts > 1 else rep["detected"][:, None]
        outs = [rxs(y, tf[:, k], cf[:, k], nv) for k in range(n_pkts)]
        return (jnp.stack([o["tb_ok"] for o in outs], -1), det, tf,
                jnp.stack([o["x_pdc"] for o in outs], 1))

    return step, T_hw, n_pkt_hw


def stream_offsets(rng, B: int, n_pkts: int, T_hw: int, n_pkt_hw: int,
                   sep: int) -> np.ndarray:
    """[B, n_pkts] packet offsets with pairwise separation >= sep."""
    out = np.zeros((B, n_pkts), np.int64)
    for i in range(B):
        while True:
            o = np.sort(rng.integers(64, T_hw - n_pkt_hw - 64, n_pkts))
            if n_pkts == 1 or np.diff(o).min() >= sep:
                out[i] = o
                break
    return out


@dataclass
class StreamCell:
    """One stream-loop configuration with its inputs at batch B."""
    name: str
    psdef: PacketSizesDef
    T_factor: int             # stream length in packet lengths (+ 8192)
    n_pkts: int               # packets per stream
    resample: bool            # 10/9 resampler in the loop
    B: int
    samp_rate_dect: int
    snr_db: float = 15.0
    nid: int = 0x12345678

    def __post_init__(self):
        ps = get_packet_sizes(self.psdef)
        self.n_tb_bits = ps.N_TB_bits
        T = ps.N_samples_packet * self.T_factor + 8192
        self.step, self.T_hw, self.n_pkt_hw = build_stream_step(
            self.psdef, T, self.n_pkts, self.resample, self.nid, self.snr_db)
        self.hw_rate = (self.samp_rate_dect * 10 // 9 if self.resample
                        else self.samp_rate_dect)
        rng = np.random.default_rng(7)
        self.plcf = jnp.asarray(rng.integers(0, 2, (self.B, 40)), jnp.uint8)
        self.tb = jnp.asarray(rng.integers(0, 2, (self.B, self.n_tb_bits)),
                              jnp.uint8)

    def args(self, i: int):
        """Step arguments of draw i (fresh noise key and packet offsets)."""
        r = np.random.default_rng(1000 + i)
        offs = stream_offsets(r, self.B, self.n_pkts, self.T_hw,
                              self.n_pkt_hw, int(1.5 * self.n_pkt_hw))
        return (self.plcf, self.tb, jax.random.PRNGKey(i),
                jnp.asarray(offs, jnp.int32))

    def gate(self, out) -> tuple[float, float]:
        """(decode_ok fraction, detection fraction) of one step's output."""
        ok, det = out[0], out[1]
        return float(np.asarray(ok).mean()), float(np.asarray(det).mean())
