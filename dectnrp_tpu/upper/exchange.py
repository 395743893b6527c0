"""Two-node exchanges through the full runtime stack, for on-card checks.

TX firmware -> vspace -> NodeRuntime sync/decode on the receiving node,
at the DECT rate (SISO) and with 2x2 N_SS=2 spatial multiplexing, plus one
loopback PER point through the sync path. Each returns its counters and an
"ok" verdict instead of asserting (tests/test_runtime.py asserts the same
flows at test size).
"""
from __future__ import annotations

import time

import numpy as np


def run_two_node_exchange() -> dict:
    """TxBeacon -> vspace -> NodeRuntime sync/decode, 2 nodes, DECT rate."""
    from ..radio.hw_simulator import HwSimulator, SimDriver
    from ..sections.part3.packet_sizes import (PacketSizesDef,
                                                         get_packet_sizes)
    from ..sections.part4.identity import Identity
    from ..sections.part4.plcf import Plcf10
    from ..simulation.topology import Position, Trajectory
    from ..simulation.vspace import VNodeConfig, VSpaceConfig
    from .runtime import NodeRuntime
    from .tpoint import (MacHighPhy, MacLowPhy, Tpoint,
                                          TxDescriptor)

    ident = Identity(0x12345678, 0x2222, 0x3333)
    psdef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    ps = get_packet_sizes(psdef)

    class TxBeacon(Tpoint):
        def __init__(self):
            super().__init__()
            self.sent = 0
            self.payloads = []

        def work_regular(self, now):
            out = MacHighPhy()
            if self.sent >= 4:          # stop early so the tail drains
                return out
            rng = np.random.default_rng(self.sent)
            tb = rng.integers(0, 2, ps.N_TB_bits).astype(np.uint8)
            self.payloads.append(tb)
            self.sent += 1
            plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                          packet_length=psdef.PacketLength,
                          short_network_id=ident.short_network_id,
                          transmitter_identity=ident.short_rdid,
                          transmit_power=7, df_mcs=psdef.mcs_index)
            # schedule respecting the hardware turnaround: `now` is the
            # MAC's (lagging) clock; with the resampler front end the radio
            # write head is up to pump-chunk + sync-chunk ahead, so a naive
            # now+margin can land behind the head and lose the burst head.
            # tx_earliest is the guaranteed-
            # schedulable floor (reference allocation_pt get_tx_opportunity
            # honoring tmin turnaround).
            out.tx_descriptors.append(TxDescriptor(
                psdef=psdef, plcf=plcf, tb_bits=tb,
                network_id=ident.network_id,
                tx_time=max(now + 2000, self.lower.tx_earliest)))
            return out

    class RxCounter(Tpoint):
        def __init__(self):
            super().__init__()
            self.pdc = 0
            self.tb_match = 0
            self.payload_ref = None

        def work_pcc(self, phy_maclow):
            rep = phy_maclow.pcc_report
            if rep.plcf is None or \
                    rep.plcf.transmitter_identity != ident.short_rdid:
                return MacLowPhy()
            return self.worksub_pcc2pdc(phy_maclow, rep.plcf_type,
                                        ident.network_id)

        def work_pdc(self, phy_machigh):
            self.pdc += 1
            got = phy_machigh.pdc_report.tb_bits
            if any(np.array_equal(got, p) for p in self.payload_ref):
                self.tb_match += 1
            return MacHighPhy()

    hw_rate = 1_728_000
    hws = [HwSimulator(1), HwSimulator(1)]
    cfg = VSpaceConfig(samp_rate=float(hw_rate), spp_len=2048,
                       noise_var=1e-8)
    nodes = [VNodeConfig(1, Trajectory(Position(0, 0, 0))),
             VNodeConfig(1, Trajectory(Position(1.0, 0, 0)))]
    drv = SimDriver(cfg, hws, nodes)
    tx_fw, rx_fw = TxBeacon(), RxCounter()
    rx_fw.payload_ref = tx_fw.payloads
    rt_tx = NodeRuntime(hws[0], tx_fw, ident.network_id,
                        regular_period=8192, hw_samp_rate=hw_rate)
    rt_rx = NodeRuntime(hws[1], rx_fw, ident.network_id,
                        hw_samp_rate=hw_rate)
    t0 = time.perf_counter()
    ticks = 0
    t_first = None
    tick_ms = []
    # run until every sent beacon is decoded (or the tick budget runs out):
    # steady state must drop NOTHING (reference rx_pacer.cpp:227-295)
    while ticks < 120:
        tt = time.perf_counter()
        drv.tick()
        rt_tx.process()
        rt_rx.process()
        tick_ms.append((time.perf_counter() - tt) * 1e3)
        ticks += 1
        if t_first is None:
            t_first = time.perf_counter() - t0
        if ticks >= 40 and rx_fw.tb_match >= tx_fw.sent \
                and not rt_rx._pending and not rt_rx._pending_pdc:
            break
    wall = time.perf_counter() - t0
    return {
        "hw_samp_rate": hw_rate,
        "tx_sent": tx_fw.sent,
        "pdc_decoded": rx_fw.pdc,
        "tb_payload_match": rx_fw.tb_match,
        "tx_late": rt_tx.stats.tx_late,
        "ticks": ticks,
        "rx_stats": vars(rt_rx.stats),
        "wall_s": wall,
        "first_tick_s": t_first or 0.0,
        # the median separates the steady tick cost from compile spikes
        # (the PCC/PDC jits compile lazily at the first detection)
        "tick_ms_median": float(np.median(tick_ms[1:])) if len(tick_ms) > 1
        else 0.0,
        "tick_ms_max": max(tick_ms),
        # every sent packet must be delivered and none scheduled late —
        # no warmup allowance needed once TX honors tx_earliest
        "ok": bool(tx_fw.sent >= 4 and rx_fw.tb_match == tx_fw.sent
                   and rt_tx.stats.tx_late == 0),
    }


def run_mimo_exchange() -> dict:
    """2x2 N_SS=2 spatial-multiplexing beacons through the FULL runtime:
    TxBeacon (tm mode 2, PLCF type 2 with n_ss=2) -> vspace -> NodeRuntime
    sync (N_eff_TX=2 detection) -> worksub_pcc2pdc derives tm 2 from
    (N_eff_TX, PLCF n_ss) -> MMSE 2-stream PDC decode. The capability the
    reference stubs (rx_synced.cpp:1331-1333), exercised at system level."""
    from ..radio.hw_simulator import HwSimulator, SimDriver
    from ..sections.part3.packet_sizes import (PacketSizesDef,
                                                         get_packet_sizes)
    from ..sections.part4.identity import Identity
    from ..sections.part4.plcf import Plcf20
    from ..simulation.topology import Position, Trajectory
    from ..simulation.vspace import VNodeConfig, VSpaceConfig
    from .runtime import NodeRuntime
    from .tpoint import (MacHighPhy, MacLowPhy, Tpoint,
                                          TxDescriptor)

    ident = Identity(0x12345678, 0x2222, 0x3333)
    psdef = PacketSizesDef(1, 1, 0, 2, 2, 2, 6144)      # tm 2: 2x2 N_SS=2
    ps = get_packet_sizes(psdef)

    class TxBeacon(Tpoint):
        def __init__(self):
            super().__init__()
            self.sent = 0
            self.payloads = []

        def work_regular(self, now):
            out = MacHighPhy()
            if self.sent >= 2:
                return out
            rng = np.random.default_rng(100 + self.sent)
            tb = rng.integers(0, 2, ps.N_TB_bits).astype(np.uint8)
            self.payloads.append(tb)
            self.sent += 1
            plcf = Plcf20(packet_length_type=psdef.PacketLengthType,
                          packet_length=psdef.PacketLength,
                          short_network_id=ident.short_network_id,
                          transmitter_identity=ident.short_rdid,
                          transmit_power=7, df_mcs=psdef.mcs_index,
                          receiver_identity=0x4444)
            plcf.set_n_ss(2)
            out.tx_descriptors.append(TxDescriptor(
                psdef=psdef, plcf=plcf, tb_bits=tb,
                network_id=ident.network_id,
                tx_time=max(now + 2000, self.lower.tx_earliest)))
            return out

    class RxCounter(Tpoint):
        def __init__(self):
            super().__init__()
            self.pdc = 0
            self.tb_match = 0
            self.payload_ref = None
            self.n_ss_seen = 0

        def work_pcc(self, phy_maclow):
            rep = phy_maclow.pcc_report
            if rep.plcf is None or \
                    rep.plcf.transmitter_identity != ident.short_rdid:
                return MacLowPhy()
            self.n_ss_seen = max(self.n_ss_seen,
                                 getattr(rep.plcf, "n_ss", 1))
            return self.worksub_pcc2pdc(phy_maclow, rep.plcf_type,
                                        ident.network_id)

        def work_pdc(self, phy_machigh):
            self.pdc += 1
            got = phy_machigh.pdc_report.tb_bits
            if any(np.array_equal(got, p) for p in self.payload_ref):
                self.tb_match += 1
            return MacHighPhy()

    rate = 1_728_000
    hws = [HwSimulator(2), HwSimulator(2)]
    cfg = VSpaceConfig(samp_rate=float(rate), spp_len=2048, noise_var=1e-8)
    nodes = [VNodeConfig(2, Trajectory(Position(0, 0, 0))),
             VNodeConfig(2, Trajectory(Position(1.0, 0, 0)))]
    drv = SimDriver(cfg, hws, nodes)
    tx_fw, rx_fw = TxBeacon(), RxCounter()
    rx_fw.payload_ref = tx_fw.payloads
    rt_tx = NodeRuntime(hws[0], tx_fw, ident.network_id,
                        regular_period=8192, hw_samp_rate=rate)
    rt_rx = NodeRuntime(hws[1], rx_fw, ident.network_id, hw_samp_rate=rate)
    t0 = time.perf_counter()
    ticks = 0
    while ticks < 80:
        drv.tick()
        rt_tx.process()
        rt_rx.process()
        ticks += 1
        if ticks >= 20 and rx_fw.tb_match >= tx_fw.sent:
            break
    return {
        "psdef": str(psdef), "n_ss": 2,
        "tx_sent": tx_fw.sent, "pdc_decoded": rx_fw.pdc,
        "tb_payload_match": rx_fw.tb_match,
        "n_ss_from_plcf": rx_fw.n_ss_seen,
        "ticks": ticks,
        "wall_s": time.perf_counter() - t0,
        "ok": bool(tx_fw.sent >= 2 and rx_fw.tb_match == tx_fw.sent
                   and rx_fw.n_ss_seen == 2),
    }


def run_per_point(snr_db: float = 15.0, n: int = 100) -> dict:
    """One loopback PER point through the sync path."""
    from ..sections.part3.packet_sizes import PacketSizesDef
    from ..sections.part4.identity import Identity
    from .loopback import _run_point

    psdef = PacketSizesDef(1, 1, 0, 2, 0, 4, 6144)
    pt = _run_point(psdef, Identity(0x12345678, 0x2222, 0x3333),
                    snr_db, n, seed=0, use_sync=True)
    return {"snr_db": snr_db, "n": pt.n, "per_pdc": pt.per_pdc,
            "per_pcc": pt.per_pcc, "snr_est_min": pt.snr_min,
            "snr_est_max": pt.snr_max, "ok": bool(pt.per_pdc <= 0.05)}
