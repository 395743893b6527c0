"""Loopback experiment firmwares: the reference's benchmark oracle family.

Counterpart of reference lib/src/upper/loopback/tfw_loopback{,_snr,_ratio,
_mmie}.cpp. The reference's five-state machine (A..E) transmits one packet at
a time into its own receiver through the simulator; here each (parameter,
SNR) point is ONE batched jit call: B packets synthesized, placed at random
offsets in noise streams, synchronized, demodulated and decoded together --
the TPU-native replacement for the packet-serial loop.

Outputs match tfw_loopback_snr_t::save_all_results_to_file: per MCS a JSON
record {snr_vec, nof_experiment_per_snr, PER_pcc_crc, PER_pcc_crc_and_plcf,
PER_pdc_crc, snr_min/max_vec}.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from ..sections.part4.identity import Identity
from ..sections.part4.plcf import Plcf10, bits_to_bytes, bytes_to_bits
from ..sections.part4.mac_pdu_decoder import build_mac_pdu, decode_mac_pdu


@dataclass
class LoopbackPoint:
    n: int
    n_pcc: int
    n_pcc_and_plcf: int
    n_pdc: int
    snr_min: float
    snr_max: float

    @property
    def per_pcc(self):
        return 1.0 - self.n_pcc / self.n

    @property
    def per_pcc_and_plcf(self):
        return 1.0 - self.n_pcc_and_plcf / self.n

    @property
    def per_pdc(self):
        return 1.0 - self.n_pdc / self.n


@lru_cache(maxsize=None)
def _point_step(psdef: PacketSizesDef, nid: int, use_sync: bool,
                quantize_bits: int | None, channel: str = "awgn",
                resampler_loop: bool = False, genie: bool = False):
    """One cached jit step shared by all SNR points of a configuration.

    Everything device-side lives inside the jit, so one point costs one
    dispatch and one fetch of the few outputs the host reads.

    channel: "awgn" or "doubly_<pdp>_<tau_ns>_<fd_hz>" (reference
    radio.json sim_channel_name_inter, channel_doubly.cpp:58-135) applied to
    the packet before placement (the noise-only regions carry no signal).
    resampler_loop: pass TX 10/9 up + RX 9/10 down through the Kaiser
    polyphase pair, reproducing the reference's ~25 dB resampler EVM floor
    (resampler_param.hpp:70-88) in the waterfall.
    genie: diagnostic mode for doubly channels — the rx equalizes with the
    TRUE per-symbol channel (doubly_selective_genie + build_rx(genie=True)),
    separating chestim tracking loss from Rayleigh outage in the fading
    floor. Aligned-only (use_sync must be False).
    Returns (step(plcf_b, tb, snr_db, key, offs, amp) -> dict, T, n_pkt).
    """
    import jax
    import jax.numpy as jnp

    from ..phy.resampler import ResamplerPlan, build_resampler
    from ..phy.rx import build_rx
    from ..phy.sync import build_rx_stream, build_sync
    from ..phy.tx import build_tx
    from ..simulation.channels import (awgn, doubly_selective,
                                       doubly_selective_genie)
    from ..simulation.hardware import clip_and_quantize

    if genie:
        assert not use_sync and channel.startswith("doubly"), \
            "genie mode is aligned-only over a doubly channel"

    ps = get_packet_sizes(psdef)
    tx = build_tx(psdef, nid, 1)
    n_pkt = ps.N_samples_packet
    samp_rate = 1_728_000 * psdef.u * psdef.b
    if resampler_loop:
        up = build_resampler(ResamplerPlan(10, 9), n_pkt)
        n_up = -(-n_pkt * 10 // 9)
        down = build_resampler(ResamplerPlan(9, 10), n_up)
    T = int(2 ** np.ceil(np.log2(n_pkt + 512)))
    if use_sync:
        sync = build_sync(psdef.u, psdef.b, T)
        rxs = build_rx_stream(psdef, nid, 1, T)
    else:
        rx = build_rx(psdef, nid, 1, genie=genie)
    if genie:
        from ..sections.part3.phyres import k_b_OCC
        q = ps.numerology
        N, cp = q.N_b_DFT, q.N_b_CP
        # FFT-window center of every packet symbol (symbol 0 = STF slot)
        sym_centers = tuple(
            min(n_pkt - 1,
                ps.N_samples_STF // 2 if sidx == 0
                else ps.N_samples_STF + (sidx - 1) * (N + cp) + cp + N // 2)
            for sidx in range(ps.N_PACKET_symb))
        k_occ = tuple(int(k) for k in k_b_OCC(psdef.b))

    @jax.jit
    def step(plcf_b, tb, snr_db, key, offs, amp):
        B = plcf_b.shape[0]
        flags = jnp.zeros((B,), bool)
        iq = tx(plcf_b, tb, flags, flags) * amp
        if quantize_bits is not None:
            iq = clip_and_quantize(iq, quantize_bits)
        sig_pow = jnp.mean(jnp.abs(iq) ** 2)
        nv = sig_pow / 10.0 ** (snr_db / 10.0)
        if resampler_loop:
            iq = down(up(iq))[..., :n_pkt]
        Hg = None
        if channel.startswith("doubly"):
            _, pdp, tau, fd = channel.split("_")
            kc, key = jax.random.split(key)
            n_rx_c = iq.shape[1] if iq.ndim == 3 else 1
            if genie:
                iq, Hg = doubly_selective_genie(
                    kc, iq.reshape(B, -1, n_pkt), n_rx_c, samp_rate,
                    sym_centers, k_occ, N, tau_rms_s=float(tau) * 1e-9,
                    doppler_hz=float(fd), pdp_idx=int(pdp))
            else:
                iq = doubly_selective(kc, iq.reshape(B, -1, n_pkt), n_rx_c,
                                      samp_rate, tau_rms_s=float(tau) * 1e-9,
                                      doppler_hz=float(fd), pdp_idx=int(pdp))
        if use_sync:
            def scatter(off, pkt):
                z = jnp.zeros((pkt.shape[0], T), jnp.complex64)
                return jax.lax.dynamic_update_slice_in_dim(z, pkt, off, -1)
            stream = jax.vmap(scatter)(offs, iq)
            y = awgn(key, stream, nv)
            rep = sync(y)
            out = dict(rxs(y, rep["t_fine"], rep["cfo"], nv))
            out["detected"] = rep["detected"]
        else:
            y = awgn(key, iq, nv)
            out = dict(rx(y, nv, Hg) if genie else rx(y, nv))
            out["detected"] = jnp.ones((B,), bool)
        return {k: out[k] for k in ("detected", "plcf1", "plcf1_ok", "tb",
                                    "tb_ok", "snr_db")}

    return step, T, n_pkt


def _run_point(psdef: PacketSizesDef, identity: Identity, snr_db: float,
               n_packets: int, seed: int, use_sync: bool,
               amplitude_scale: float = 1.0, quantize_bits: int | None = None,
               channel: str = "awgn", resampler_loop: bool = False,
               genie: bool = False):
    """One batched loopback point: TX -> [scale/clip/quantize] ->
    [resample-pair] -> [fading] -> AWGN -> [sync] -> RX decode.
    Returns a LoopbackPoint."""
    import jax
    import jax.numpy as jnp

    ps = get_packet_sizes(psdef)
    B = n_packets
    nid = identity.network_id
    step, T, n_pkt = _point_step(psdef, nid, use_sync, quantize_bits,
                                 channel, resampler_loop, genie)
    rng = np.random.default_rng(seed)

    plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                  packet_length=psdef.PacketLength,
                  short_network_id=identity.short_network_id,
                  transmitter_identity=identity.short_rdid,
                  transmit_power=7, df_mcs=psdef.mcs_index)
    plcf_bits = bytes_to_bits(plcf.pack(), 40)
    plcf_b = jnp.asarray(np.tile(plcf_bits, (B, 1)), jnp.uint8)
    tb = jnp.asarray(rng.integers(0, 2, (B, ps.N_TB_bits)), jnp.uint8)
    offs = jnp.asarray(rng.integers(64, T - n_pkt - 64, B), jnp.int32)
    out = step(plcf_b, tb, jnp.float32(snr_db), jax.random.PRNGKey(seed),
               offs, jnp.float32(amplitude_scale))
    detected = np.asarray(out["detected"])

    pcc_ok = np.asarray(out["plcf1_ok"]) & detected
    pdc_ok = np.asarray(out["tb_ok"]) & pcc_ok
    snr_est = np.asarray(out["snr_db"])

    # PLCF content check (reference work_pcc: transmitter identity match)
    plcf_rx = np.asarray(out["plcf1"])
    plcf_match = np.zeros(B, bool)
    for i in np.nonzero(pcc_ok)[0]:
        c = Plcf10()
        if c.unpack(bits_to_bytes(plcf_rx[i])) and \
                c.transmitter_identity == identity.short_rdid:
            plcf_match[i] = True

    good = pdc_ok & plcf_match
    tb_match = good & np.all(np.asarray(out["tb"]) == np.asarray(tb), axis=1)
    if tb_match.any():
        snrs = snr_est[tb_match]
        snr_min, snr_max = float(snrs.min()), float(snrs.max())
    else:
        snr_min = snr_max = float("nan")
    return LoopbackPoint(
        n=B, n_pcc=int(pcc_ok.sum()), n_pcc_and_plcf=int(plcf_match.sum()),
        n_pdc=int(tb_match.sum()), snr_min=snr_min, snr_max=snr_max)


@dataclass
class LoopbackSnrExperiment:
    """PER vs SNR per MCS (reference tfw_loopback_snr.cpp:34-187:
    MCS 1-6 x SNR -2..20 dB x 100 packets)."""
    identity: Identity = field(
        default_factory=lambda: Identity(0x12345678, 0x2222, 0x3333))
    u: int = 1
    b: int = 1
    packet_length_type: int = 0
    packet_length: int = 2
    tm_mode_index: int = 0        # e.g. 2 = 2x2 N_SS=2 spatial multiplexing
    mcs_list: tuple[int, ...] = (1, 2, 3, 4, 5, 6)
    snr_db: tuple[float, ...] = tuple(float(s) for s in range(-2, 21))
    n_per_snr: int = 100
    use_sync: bool = True
    channel: str = "awgn"            # or "doubly_<pdp>_<tau_ns>_<fd_hz>"
    resampler_loop: bool = False     # TX 10/9 up + RX 9/10 down in the loop
    genie: bool = False              # true-channel equalization (aligned)
    seed: int = 0

    def run(self) -> dict:
        results = {}
        for mcs in self.mcs_list:
            psdef = PacketSizesDef(self.u, self.b, self.packet_length_type,
                                   self.packet_length, self.tm_mode_index,
                                   mcs, 6144)
            if get_packet_sizes(psdef) is None:
                continue
            pts = []
            for i, snr in enumerate(self.snr_db):
                pts.append(_run_point(psdef, self.identity, snr,
                                      self.n_per_snr,
                                      self.seed + 1000 * mcs + i,
                                      self.use_sync,
                                      channel=self.channel,
                                      resampler_loop=self.resampler_loop,
                                      genie=self.genie))
            results[mcs] = {
                "experiment_range": {"snr_vec": list(self.snr_db),
                                     "nof_experiment_per_snr": self.n_per_snr},
                "parameter": {"mcs": mcs, "channel": self.channel,
                              "resampler_loop": self.resampler_loop},
                "result": {
                    "snr_max_vec": [p.snr_max for p in pts],
                    "snr_min_vec": [p.snr_min for p in pts],
                    "PER_pcc_crc": [p.per_pcc for p in pts],
                    "PER_pcc_crc_and_plcf": [p.per_pcc_and_plcf for p in pts],
                    "PER_pdc_crc": [p.per_pdc for p in pts],
                },
            }
        return results

    def save_json(self, out_dir: str) -> list[str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for mcs, rec in self.run().items():
            p = os.path.join(out_dir, f"rx_loopback_MCS_{mcs:04d}.json")
            with open(p, "w") as f:
                json.dump(rec, f, indent=4)
            paths.append(p)
        return paths


@dataclass
class LoopbackRatioExperiment:
    """PER vs TX amplitude ratio under clip+quantize at fixed SNR
    (reference tfw_loopback_ratio.cpp)."""
    identity: Identity = field(
        default_factory=lambda: Identity(0x12345678, 0x2222, 0x3333))
    psdef: PacketSizesDef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    snr_db: float = 30.0
    ratios: tuple[float, ...] = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0)
    quantize_bits: int = 12
    n_per_ratio: int = 50
    use_sync: bool = False
    seed: int = 0

    def run(self) -> dict:
        pts = {}
        for i, r in enumerate(self.ratios):
            pts[r] = _run_point(self.psdef, self.identity, self.snr_db,
                                self.n_per_ratio, self.seed + i,
                                self.use_sync, amplitude_scale=r,
                                quantize_bits=self.quantize_bits)
        return pts


def loopback_mmie_roundtrip(mmies, identity: Identity,
                            psdef: PacketSizesDef | None = None,
                            snr_db: float = 20.0, seed: int = 0):
    """MMIE codec round trip over the air (reference tfw_loopback_mmie.cpp):
    build a MAC PDU from `mmies`, TX through AWGN loopback, decode the PDU.
    Returns the list of decoded MMIEs (asserting CRC pass)."""
    import jax
    import jax.numpy as jnp

    from ..phy.rx import build_rx
    from ..phy.tx import build_tx
    from ..sections.part4.mac_pdu import (BeaconHeader, MacHeaderKind,
                                          MacHeaderType)
    from ..simulation.channels import awgn

    from ..sections.part3.packet_sizes import get_packet_sizes as gps

    mht = MacHeaderType(mac_header_type=MacHeaderKind.BEACON)
    ch = BeaconHeader(network_id_3_lsb=identity.network_id & 0xFFFFFF,
                      transmitter_address=identity.long_rdid)
    need = 1 + ch.SIZE + sum(m.packed_size_mmh_sdu() for m in mmies)

    if psdef is None:
        for plen in range(1, 17):
            psdef = PacketSizesDef(1, 1, 0, plen, 0, 2, 6144)
            ps = gps(psdef)
            if ps is not None and ps.N_TB_bits // 8 >= need:
                break
    ps = gps(psdef)
    assert ps.N_TB_bits // 8 >= need, "MAC PDU does not fit TB"

    pdu = build_mac_pdu(mht, ch, mmies, tb_size_bytes=ps.N_TB_bits // 8)
    tb_bits = np.unpackbits(np.frombuffer(pdu, np.uint8))[:ps.N_TB_bits]

    nid = identity.network_id
    tx = build_tx(psdef, nid, 1)
    rx = build_rx(psdef, nid, 1)
    plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                  packet_length=psdef.PacketLength,
                  short_network_id=identity.short_network_id,
                  transmitter_identity=identity.short_rdid,
                  df_mcs=psdef.mcs_index)
    plcf_b = np.asarray(bytes_to_bits(plcf.pack(), 40)[None, :], np.uint8)
    fl = np.zeros((1,), bool)

    # one jit end to end: no complex (and no eager op) at the boundary
    @jax.jit
    def roundtrip(plcf_b, tb, key):
        iq = tx(plcf_b, tb, jnp.asarray(fl), jnp.asarray(fl))
        sig = jnp.mean(jnp.abs(iq) ** 2)
        nv = sig / 10.0 ** (snr_db / 10.0)
        out = rx(awgn(key, iq, nv), nv)
        return out["tb_ok"], out["tb"]

    tb_ok, tb_rx = roundtrip(plcf_b, tb_bits[None, :].astype(np.uint8),
                             jax.random.PRNGKey(seed))
    out = {"tb_ok": tb_ok, "tb": tb_rx}
    assert bool(out["tb_ok"][0]), "loopback decode failed"
    rx_pdu = np.packbits(np.asarray(out["tb"][0], np.uint8)).tobytes()
    dec = decode_mac_pdu(rx_pdu)
    assert not dec.aborted
    return dec.mmies
