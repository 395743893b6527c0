"""Node runtime: chunked sync search + packet decode + tpoint callbacks.

TPU-native counterpart of the reference PHY pool (lib/src/phy/pool/):
worker_sync_t's chunked ring search, the job queue, token-serialized tpoint
calls and worker_tx_rx_t's pcc->work_pcc->pdc->work_pdc dispatch collapse
into one single-threaded `NodeRuntime.process()` driven after each SimDriver
tick; all heavy lifting (sync correlations, demod, FEC) stays in jit.

Blind packet-dimension handling: the PCC sits in the first symbols at cells
that depend only on (u, b, N_TS), so the PCC stage runs the aligned rx of a
minimum-length packet of the detected geometry (its PDC output is ignored);
once the PLCF yields the true PacketLength/MCS, the full packet is
re-demodulated with the right psdef (the reference's two-phase
demoddecod_rx_pcc / demoddecod_rx_pdc split, rx_synced.cpp:186-436).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..phy.resampler import (ResamplerPlan, build_resampler,
                             build_resampler_stream, get_resampler_fraction,
                             stream_input_lag)
from ..phy.sync import build_sync, build_rx_stream
from ..phy.tx import build_tx
from ..sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from ..sections.part3.transmission_packet_structure import get_N_samples_STF
from ..sections.part4.plcf import decode_plcf
from .tpoint import (IrregularReport, MacHighPhy, MacLowPhy, PccReport,
                     PdcReport, PhyMacHigh, PhyMacLow, SyncReport, Tpoint,
                     TxDescriptor)


@lru_cache(maxsize=None)
def _min_len_psdef(u: int, b: int, tm_mode_index: int) -> PacketSizesDef:
    """Smallest valid packet of this geometry (PCC cells are identical)."""
    for plt, plen in ((0, 1), (0, 2), (0, 4), (1, 1), (1, 2)):
        psdef = PacketSizesDef(u, b, plt, plen, tm_mode_index, 0, 6144)
        if get_packet_sizes(psdef) is not None:
            return psdef
    raise ValueError("no valid minimum psdef")


@dataclass
class RuntimeStats:
    """Counters mirroring the reference's worker stats (worker_tx_rx.cpp:269)."""
    chunks: int = 0
    detections: int = 0
    detections_dropped: int = 0    # pending PCC lost to a ring-overrun skip
    pcc_ok: int = 0
    pcc_err: int = 0
    pdc_ok: int = 0
    pdc_err: int = 0
    tx_packets: int = 0
    tx_late: int = 0               # scheduled behind the radio write head
    regular_calls: int = 0
    irregular_calls: int = 0


class _DectLower:
    """hw facade exposing a DECT-rate clock to the firmware.

    When the radio runs at an SDR rate (reference: hw picks e.g. 1.92 Ms/s
    for a 1.728 Ms/s DECT rate, phy_config.cpp:32-67), all firmware/MAC times
    stay in DECT-rate sample counts (part-3 sample durations are DECT-rate
    quantities); the runtime converts at the hw boundary. Timed-command and
    PPS times are converted here; everything else forwards to the hw.
    """

    def __init__(self, hw, rt: "NodeRuntime"):
        self._hw = hw
        self._rt = rt

    @property
    def rx_time(self) -> int:
        return self._rt._hw_to_dect(self._hw.rx_time)

    @property
    def rx_time_passed(self) -> int:
        return self._rt._dect_time_passed

    def set_command_time(self, time: int = 0) -> None:
        self._hw.set_command_time(self._rt._dect_to_hw(time) if time > 0 else time)

    def pps_set_full_sec_at_next_pps(self) -> int:
        return self._rt._hw_to_dect(self._hw.pps_set_full_sec_at_next_pps())

    @property
    def tx_earliest(self) -> int:
        return self._rt._hw_to_dect(self._hw.tx_earliest)

    def __getattr__(self, name):
        return getattr(self._hw, name)


class NodeRuntime:
    """Per-node MAC/PHY event loop over a HwSimulator's RX ring.

    hw_samp_rate: actual radio rate. When it differs from the DECT rate
    (1.728 MHz * u * b), a streaming polyphase front end converts the hw-rate
    ring into a local DECT-rate buffer before sync/demod (reference rx_pacer
    resample_until_nto, rx_pacer.cpp:227-295 / sync_chunk.cpp:43-50), and TX
    packets are upsampled L/M before scheduling (tx.cpp
    run_resampling_and_freq_shift). All runtime/firmware times are DECT-rate
    sample counts; conversion happens only at the hw boundary.
    """

    def __init__(self, hw, tpoint: Tpoint, network_id: int,
                 u: int = 1, b: int = 1,
                 chunk_len: int = 2048,
                 regular_period: int | None = None,
                 tm_by_n_eff: dict[int, int] | None = None,
                 app_server=None, app_client=None,
                 hw_samp_rate: int | None = None,
                 json_export_dir: str | None = None):
        self.hw = hw
        self.tpoint = tpoint
        self.network_id = network_id
        self.u, self.b = u, b
        self.chunk_len = chunk_len
        self.overlap = 4 * get_N_samples_STF(u, b)
        self.regular_period = regular_period
        # detected N_eff_TX -> tm_mode used for demod (single-stream default)
        self.tm_by_n_eff = tm_by_n_eff or {1: 0, 2: 1, 4: 5, 8: 10}
        self.stats = RuntimeStats()
        self._processed = 0            # DECT-rate time up to which sync ran
        self._last_regular = 0
        self._irregular: list[tuple[int, int]] = []    # (time, handle)
        self._handled_times: list[int] = []
        self._pending: list[tuple] = []        # detections awaiting PCC window
        self._pending_pdc: list[tuple] = []    # PCC done, awaiting full packet
        self._started = False
        # up to 4 packets per chunk (reference sync_chunk keeps searching
        # after each hit, sync_chunk.cpp:146-278)
        self.max_peaks = 4
        self._sync = build_sync(u, b, chunk_len + self.overlap,
                                max_peaks=self.max_peaks)
        self._stf_len = get_N_samples_STF(u, b)
        # application layer (reference posts application_report_t jobs into
        # the PHY job queue, README.md:248; here: drained per process())
        self.app_server = app_server
        self.app_client = app_client
        # per-received-packet JSON records (reference worker_tx_rx.cpp:
        # 355-415 json_export of sync report/channel/PLCF per packet,
        # README.md:333-337 — feeds the offline analysis tooling)
        self.json_export = None
        if json_export_dir is not None:
            from ..common.json_export import JsonExport
            self.json_export = JsonExport(json_export_dir, prefix="packets")

        # --- resampling front end (rx_pacer analog)
        self.dect_rate = 1_728_000 * u * b
        hw_rate = hw_samp_rate or getattr(hw, "samp_rate", 0) or self.dect_rate
        L, M = get_resampler_fraction(self.dect_rate, hw_rate)
        self.plan_tx = ResamplerPlan(L, M)             # dect -> hw
        self.plan_rx = ResamplerPlan(M, L)             # hw -> dect
        if self.plan_tx.identity:
            tpoint.lower = hw
        else:
            tpoint.lower = _DectLower(hw, self)
            self._chunk_pump = 512 * L                 # hw samples per step
            step, self._rx_H = build_resampler_stream(
                self.plan_rx, self._chunk_pump)
            self._rx_step = step
            self._d_in = stream_input_lag(self.plan_rx)
            self._hist = None
            self._hw_origin: int | None = None         # hw time of feed start
            self._hw_consumed = 0
            cap = getattr(hw, "rx_ring_len", 1 << 20)
            self._dbuf = np.zeros((hw.n_ant, cap), np.complex64)
            self._dbuf_time = 0                        # dect index of col 0
            self._dbuf_filled = 0

    # -------------------------------------------------------- time domains
    def _dect_to_hw(self, t_d: int) -> int:
        """DECT-rate sample count -> hw sample count (same instant)."""
        if self.plan_tx.identity:
            return t_d
        L, M = self.plan_rx.L, self.plan_rx.M          # dect k ~ hw k*M/L - D
        return int(round(t_d * M / L)) - self._d_in + (self._hw_origin or 0)

    def _hw_to_dect(self, t_h: int) -> int:
        if self.plan_tx.identity:
            return t_h
        L, M = self.plan_rx.L, self.plan_rx.M
        return int(round((t_h - (self._hw_origin or 0) + self._d_in) * L / M))

    @property
    def _dect_time_passed(self) -> int:
        if self.plan_tx.identity:
            return self.hw.rx_time_passed
        return self._dbuf_time + self._dbuf_filled

    def _get_stream(self, t0: int, n: int) -> np.ndarray:
        """[A, n] DECT-rate samples for window [t0, t0+n)."""
        if self.plan_tx.identity:
            return self.hw.get_rx_stream(t0, n)
        off = t0 - self._dbuf_time
        assert 0 <= off and off + n <= self._dbuf_filled, \
            f"window [{t0},{t0+n}) outside dect buffer " \
            f"[{self._dbuf_time},{self._dbuf_time+self._dbuf_filled})"
        return self._dbuf[:, off:off + n]

    def _append_dect(self, y: np.ndarray) -> None:
        n = y.shape[-1]
        cap = self._dbuf.shape[-1]
        if n >= cap:                       # giant skip: keep only the tail
            self._dbuf[:] = y[:, -cap:]
            self._dbuf_time += self._dbuf_filled + n - cap
            self._dbuf_filled = cap
            return
        if self._dbuf_filled + n > cap:
            drop = self._dbuf_filled + n - cap
            self._dbuf[:, :-drop] = self._dbuf[:, drop:]
            self._dbuf_time += drop
            self._dbuf_filled -= drop
        self._dbuf[:, self._dbuf_filled:self._dbuf_filled + n] = y
        self._dbuf_filled += n

    def _pump(self) -> None:
        """Resample newly received hw samples into the DECT-rate buffer."""
        if self.plan_tx.identity:
            return
        if self._hw_origin is None:
            self._hw_origin = self.hw.rx_time
            self._hw_consumed = self._hw_origin
            self._hist = np.zeros((self.hw.n_ant, self._rx_H), np.complex64)
        while self._hw_consumed + self._chunk_pump <= self.hw.rx_time_passed:
            try:
                x = self.hw.get_rx_stream(self._hw_consumed, self._chunk_pump)
            except ValueError:
                # ring overflow: the producer lapped this reader. Skip to the
                # oldest sample still in the ring and zero-fill the lost span
                # so the hw<->dect time mapping stays intact (reference
                # overflow recovery: the recv loop recomputes ring time from
                # md.time_spec and restreams, hw_usrp.cpp:1093-1219)
                oldest = self.hw.rx_time
                skip = max(1, -(-(oldest - self._hw_consumed)
                                // self._chunk_pump))
                out_per_chunk = self._chunk_pump * self.plan_rx.L \
                    // self.plan_rx.M
                self._hw_consumed += skip * self._chunk_pump
                self._hist = np.zeros_like(self._hist)
                self._append_dect(np.zeros(
                    (self.hw.n_ant, skip * out_per_chunk), np.complex64))
                continue
            y, self._hist = self._rx_step(x, self._hist)
            self._hw_consumed += self._chunk_pump
            self._append_dect(np.asarray(y))

    # ------------------------------------------------------------------ TX
    def _transmit(self, machigh: MacHighPhy) -> None:
        from ..sections.part4.plcf import bytes_to_bits
        for td in machigh.tx_descriptors:
            ps = get_packet_sizes(td.psdef)
            tx = build_tx(td.psdef, td.network_id or self.network_id,
                          td.plcf.TYPE, td.codebook_index)
            n_bits = 40 if td.plcf.TYPE == 1 else 80
            plcf_bits = bytes_to_bits(td.plcf.pack(), n_bits)
            tb = td.tb_bits if td.tb_bits is not None else \
                np.zeros(ps.N_TB_bits, np.uint8)
            fl = np.zeros((1,), bool)
            iq = tx(plcf_bits[None],
                    np.asarray(tb)[None].astype(np.uint8), fl, fl)[0]
            if not self.plan_tx.identity:
                rs = build_resampler(self.plan_tx, iq.shape[-1])
                iq = rs(iq)
            iq = np.asarray(iq)
            t_hw = self._dect_to_hw(td.tx_time)
            if t_hw < self.hw.rx_time_passed:
                # behind the radio write head: the burst head is lost
                # (reference: UHD late-command error accounting)
                self.stats.tx_late += 1
            self.hw.tx_schedule(t_hw, iq[:self.hw.n_ant])
            self.stats.tx_packets += 1
            if td.hp_tx is not None:
                td.hp_tx.finalize_now()
        if machigh.irregular.call_at is not None:
            self._irregular.append((machigh.irregular.call_at,
                                    machigh.irregular.handle))

    # ------------------------------------------------------------------ RX
    def _is_unique(self, t: int) -> bool:
        """Baton unique-sync-time filter (worker_pool.cpp:299-324)."""
        for h in self._handled_times:
            if abs(t - h) < self._stf_len:
                return False
        self._handled_times.append(t)
        if len(self._handled_times) > 64:
            self._handled_times = self._handled_times[-32:]
        return True

    def _noise_var(self, chunk: np.ndarray) -> float:
        return float(np.median(np.abs(chunk) ** 2) + 1e-12)

    def _handle_detection(self, t_global: int, cfo: float, n_eff: int,
                          metric: float, rms: float) -> bool:
        """PCC-first streaming decode (reference worker_tx_rx.cpp:110-228).

        Fires `work_pcc` as soon as the minimum-length window (STF + the PCC
        symbols) is buffered — NOT after a worst-case maximum-length packet:
        the reference decodes the PCC from the first ~5 OFDM symbols
        (rx_synced.cpp:186-323) and only then decides on the PDC. The PDC
        stage runs once the PLCF-declared packet length has arrived
        (`_run_pdc`, retried via `_pending_pdc`). Returns False if the PCC
        window is not fully received yet (retry next process()).
        """
        tm = self.tm_by_n_eff.get(n_eff, 0)
        sr = SyncReport(True, t_global, cfo, n_eff, metric, rms, self.u, self.b)

        # --- PCC stage on the minimum-length packet window
        ps_min = _min_len_psdef(self.u, self.b, tm)
        n_min = get_packet_sizes(ps_min).N_samples_packet
        if t_global + n_min > self._dect_time_passed:
            return False
        try:
            win = self._get_stream(t_global, n_min)
        except ValueError:
            # identity-plan ring overrun between the time check and the
            # read: the samples are gone; drop the detection (reference
            # overflow semantics: restream, packet lost)
            self.stats.pcc_err += 1
            return True
        nv = self._noise_var(win)
        rxs = build_rx_stream(ps_min, self.network_id, 1, n_min)
        out = rxs(win[None], np.asarray([0]),
                  np.asarray([cfo], np.float32), np.float32(nv))
        plcf_bits, plcf_type = None, 0
        if bool(out["plcf1_ok"][0]):
            plcf_bits, plcf_type = np.asarray(out["plcf1"][0]), 1
        elif bool(out["plcf2_ok"][0]):
            plcf_bits, plcf_type = np.asarray(out["plcf2"][0]), 2
        if plcf_type == 0:
            self.stats.pcc_err += 1
            pcc_fail = PccReport(False, 0, None, None)
            if self.json_export is not None:
                from ..common.json_export import packet_record
                self.json_export.append(packet_record(
                    sr, pcc_fail, float(out["snr_db"][0]), None))
            self._transmit(self.tpoint.work_pcc_error(
                PhyMacLow(sr, pcc_fail)))
            return True
        plcf = decode_plcf(plcf_type, plcf_bits)
        pcc_rep = PccReport(True, plcf_type, plcf, plcf_bits,
                            bool(out[f"plcf{plcf_type}_cl"][0]),
                            bool(out[f"plcf{plcf_type}_bf"][0]),
                            float(out["snr_db"][0]))
        self.stats.pcc_ok += 1
        phy_maclow = PhyMacLow(sr, pcc_rep)
        maclow = self.tpoint.work_pcc(phy_maclow)
        if not maclow.continue_with_pdc or plcf is None:
            return True
        if not self._run_pdc(t_global, cfo, nv, phy_maclow, maclow):
            self._pending_pdc.append((t_global, cfo, nv, phy_maclow, maclow))
        return True

    def _drop_pdc(self, phy_maclow: PhyMacLow, maclow: MacLowPhy) -> None:
        """A promised PDC can no longer be demodulated (overrun skip ate the
        window): release the HARQ lease, count the error and tell the
        firmware — silence would leak HARQ processes and hide the loss."""
        if maclow.hp_rx is not None:
            maclow.hp_rx.finalize_now()
        self.stats.pdc_err += 1
        self._transmit(self.tpoint.work_pdc_error(
            PhyMacHigh(phy_maclow, PdcReport(False, None, 0.0, None))))

    def _run_pdc(self, t_global: int, cfo: float, nv: float,
                 phy_maclow: PhyMacLow, maclow: MacLowPhy) -> bool:
        """PDC stage with the PLCF-declared psdef; False = window not in yet."""
        psdef = maclow.psdef
        ps = get_packet_sizes(psdef)
        if t_global + ps.N_samples_packet > self._dect_time_passed:
            return False
        try:
            win = self._get_stream(t_global, ps.N_samples_packet)
        except ValueError:
            self._drop_pdc(phy_maclow, maclow)
            return True
        rx2 = build_rx_stream(psdef, maclow.network_id, maclow.plcf_type,
                              ps.N_samples_packet)
        out2 = rx2(win[None], np.asarray([0]),
                   np.asarray([cfo], np.float32), np.float32(nv))
        ok = bool(out2["tb_ok"][0])
        from ..phy.mimo import reports_from_cells
        mimo = reports_from_cells(np.asarray(out2["h_cells"]))[0]
        pdc_rep = PdcReport(ok, np.asarray(out2["tb"][0]) if ok else None,
                            float(out2["snr_db"][0]), mimo)
        if maclow.hp_rx is not None:
            maclow.hp_rx.finalize_now()
        phy_machigh = PhyMacHigh(phy_maclow, pdc_rep)
        if self.json_export is not None:
            from ..common.json_export import packet_record
            from ..sections.part4.plcf import bits_to_bytes
            pcc = phy_maclow.pcc_report
            rec = packet_record(
                phy_maclow.sync_report, pcc, float(out2["snr_db"][0]),
                bits_to_bytes(pcc.plcf_bits) if pcc.plcf_bits is not None
                else None)
            rec["pdc"] = {"crc_ok": ok, "n_tb_bits": int(ps.N_TB_bits),
                          "mcs": int(psdef.mcs_index),
                          "sto_frac": float(out2["sto_frac"][0]),
                          "cfo_res": float(out2["cfo_res"][0])}
            self.json_export.append(rec)
        if ok:
            self.stats.pdc_ok += 1
            self._transmit(self.tpoint.work_pdc(phy_machigh))
        else:
            self.stats.pdc_err += 1
            self._transmit(self.tpoint.work_pdc_error(phy_machigh))
        return True

    # ------------------------------------------------------------------ loop
    def process(self) -> None:
        """Advance sync/decode/callbacks as far as received samples allow."""
        self._pump()
        if not self._started:
            self._started = True
            now_d = self._hw_to_dect(self.hw.rx_time)
            irr = self.tpoint.work_start(now_d)
            if irr.call_at is not None:
                self._irregular.append((irr.call_at, irr.handle))
            self._processed = now_d
            self._last_regular = now_d

        # application ingress/egress (application_report_t jobs)
        if self.app_server is not None:
            if hasattr(self.app_server, "poll"):
                self.app_server.poll()
            datagrams = self.app_server.read_all()
            if datagrams:
                self._transmit(self.tpoint.work_application(datagrams))
        if self.app_client is not None:
            out = getattr(self.tpoint, "app_rx", None)
            if out:
                self.app_client.write_all(out)
                out.clear()

        # retry stages waiting for more samples: PDC first (older packets,
        # FIFO job order), then detections awaiting their PCC window
        window_start = self._dbuf_time if not self.plan_tx.identity \
            else self.hw.rx_time
        still_pdc = []
        for args in self._pending_pdc:
            if args[0] < window_start:
                self._drop_pdc(args[3], args[4])    # lost to an overrun skip
            elif not self._run_pdc(*args):
                still_pdc.append(args)
        self._pending_pdc = still_pdc
        still = []
        for args in self._pending:
            if args[0] < window_start:
                # lost to an overrun skip before its PCC window arrived —
                # count it (the PDC path's _drop_pdc analog; silence here
                # hid real detection losses from the stats)
                self.stats.detections_dropped += 1
                continue
            if not self._handle_detection(*args):
                still.append(args)
        self._pending = still

        while self._processed + self.chunk_len + self.overlap \
                <= self._dect_time_passed:
            if self._processed < window_start:
                # overrun skip moved the window past the sync cursor
                self._processed = window_start
            t0 = self._processed
            try:
                chunk = self._get_stream(t0, self.chunk_len + self.overlap)
            except ValueError:
                # identity-plan ring overflow: sync fell behind the producer;
                # skip forward to the oldest sample still available (the lost
                # span is unrecoverable, reference restream on overflow)
                self._processed = max(self._processed + self.chunk_len,
                                      self.hw.rx_time)
                continue
            rep = self._sync(chunk[None])
            self.stats.chunks += 1
            det = np.asarray(rep["detected"][0])
            tf = np.asarray(rep["t_fine"][0])
            # handle peaks in time order (the reference enqueues sync
            # reports FIFO as the search advances through the chunk)
            for k in np.argsort(tf):
                if not bool(det[k]):
                    continue
                t_fine = int(tf[k])
                t_global = t0 + t_fine
                if t_fine < self.chunk_len and self._is_unique(t_global):
                    self.stats.detections += 1
                    args = (t_global, float(rep["cfo"][0][k]),
                            int(rep["n_eff_tx"][0][k]),
                            float(rep["metric"][0][k]),
                            float(rep["rms"][0][k]))
                    if not self._handle_detection(*args):
                        self._pending.append(args)
            self._processed += self.chunk_len

            # regular job cadence (baton_t::is_job_regular_due)
            if self.regular_period is not None and \
                    self._processed - self._last_regular >= self.regular_period:
                self._last_regular = self._processed
                self.stats.regular_calls += 1
                self._transmit(self.tpoint.work_regular(self._processed))

            # irregular queue (irregular_queue_t)
            due = [x for x in self._irregular if x[0] <= self._processed]
            self._irregular = [x for x in self._irregular if x[0] > self._processed]
            for t, handle in sorted(due):
                self.stats.irregular_calls += 1
                self._transmit(self.tpoint.work_irregular(t, handle))
