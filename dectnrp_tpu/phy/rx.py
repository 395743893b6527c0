"""Synchronized RX: whole-packet demodulation + decode as one jit.

TPU-native counterpart of the reference's per-symbol rx_synced state machine
(lib/src/phy/rx/rx_synced/rx_synced.cpp:186-436). Instead of streaming symbol
by symbol, the full packet demodulates per jit call, batched over packets and
RX antennas:

  iq -> CP strip + batched FFT -> DRS ZF channel estimates
     -> static freq (Wiener/linear) x time (lr_t/lr_f) interpolation matmuls
     -> PCC cells: MRC or Alamouti combine -> QPSK soft demap
     -> blind PLCF type 1 AND type 2 turbo decode + CRC mask check
     -> PDC cells: MRC / Alamouti combine -> soft demap -> turbo decode
     -> TB CRC.

Assumes time/frequency-aligned input at the native DECT rate (the sync stage,
phy/rx_sync.py, produces that alignment; perfect in loopback tests).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..sections.part3.drs import get_N_step
from ..sections.part3.packet_sizes import PacketSizesDef
from ..sections.part3.stf import cover_sequence, n_stf_patterns
from ..sections.part3.tx_div import TS_PAIRS, get_modulo
from .chestim import (NU_TIME_PRESETS, WIENER_PRESETS, _j0, comb_offsets,
                      freq_interp_matrices, time_interp_matrix,
                      wiener_time_matrix)
from .fec.chain import PdcPlan, pcc_decode, pdc_decode
from .modulation import demap_llr
from .packet_config import get_packet_luts


def _pair_ts(n_cells: int, N_TS: int) -> tuple[np.ndarray, np.ndarray]:
    """Per cell-pair (ts_a, ts_b) transmit-stream indices of the Alamouti map."""
    pairs = TS_PAIRS[N_TS]
    mod = get_modulo(N_TS)
    p = np.arange(n_cells // 2) % mod
    return pairs[p, 0].astype(np.int32), pairs[p, 1].astype(np.int32)


def _exp_ramp(phase_per_n, n_len: int):
    """exp(1j * phase_per_n * n) for n in [0, n_len) as an outer product.

    A direct exp over [B, n_len] evaluates n_len transcendentals per row
    (11.8 M at the u8b16 packet); the factorization
    e^{j p n} = e^{j p 256 q} * e^{j p r} (n = 256 q + r) needs only
    n_len/256 + 256 exps per row plus one complex outer product — the
    multiply is bandwidth-bound and ~20x cheaper than VPU transcendentals.
    Returns [B, n_len] complex64.
    """
    B = phase_per_n.shape[0]
    nq = -(-n_len // 256)
    q = jnp.arange(nq, dtype=jnp.float32) * 256.0
    r = jnp.arange(256, dtype=jnp.float32)
    A = jnp.exp(1j * phase_per_n[:, None] * q[None, :])       # [B, nq]
    Bt = jnp.exp(1j * phase_per_n[:, None] * r[None, :])      # [B, 256]
    return (A[:, :, None] * Bt[:, None, :]).reshape(B, nq * 256)[:, :n_len]


def _mrc(y, h):
    """y [B,R,n], h [B,R,n] -> (x_eq [B,n], csi [B,n])."""
    den = jnp.sum(jnp.abs(h) ** 2, axis=1)
    num = jnp.sum(jnp.conj(h) * y, axis=1)
    x = num / jnp.maximum(den, 1e-12)
    return x, den


def _mmse(y, h, nv, N_SS):
    """Per-cell MMSE spatial equalizer for N_SS>1 spatial multiplexing.

    y [B,R,n], h [B,R,S,n] -> (x_eq unbiased [B,S,n], sinr [B,S,n]).
    The reference stubs this path (rx_synced.cpp:1331-1333 run_pdc_mode_
    AxA_MIMO is a todo); implemented here as the intended capability:
    x_hat = (H^H H + nv I)^-1 H^H y, unbiased by the diagonal gain, with
    per-stream post-MMSE SINR g/(1-g) as the demapper CSI.
    """
    H = jnp.moveaxis(h, (1, 2), (2, 3))                   # [B,n,R,S]
    yv = jnp.moveaxis(y, 1, 2)[..., None]                 # [B,n,R,1]
    Hh = jnp.conj(jnp.swapaxes(H, -1, -2))                # [B,n,S,R]
    gram = Hh @ H + nv * jnp.eye(N_SS, dtype=h.dtype)     # [B,n,S,S]
    rhs = Hh @ yv                                         # [B,n,S,1]
    x = jnp.linalg.solve(gram, rhs)[..., 0]               # [B,n,S]
    ginv = jnp.linalg.inv(gram)
    g = 1.0 - nv * jnp.real(jnp.diagonal(ginv, axis1=-2, axis2=-1))
    g = jnp.clip(g, 1e-6, 1.0 - 1e-6)
    x_unb = x / g.astype(x.dtype)
    sinr = g / (1.0 - g)
    return jnp.moveaxis(x_unb, 1, 2), jnp.moveaxis(sinr, 1, 2)


def _alamouti(y, h, ts_a, ts_b):
    """y [B,R,n], h [B,R,N_TS,n] -> (x_eq [B,n], csi [B,n]).

    TX mapping (tx_div.alamouti_map): ta carries (x0, x1)/sqrt2,
    tb carries (-x1*, x0*)/sqrt2. csi is the post-combining |h_eff|^2.
    """
    n_pairs = ts_a.size
    y0, y1 = y[..., 0::2], y[..., 1::2]                          # [B,R,P]
    h_even = h[..., 0::2]                                        # [B,R,T,P]
    pair_idx = jnp.arange(n_pairs)
    ha = h_even[:, :, jnp.asarray(ts_a), pair_idx]               # [B,R,P]
    hb = h_even[:, :, jnp.asarray(ts_b), pair_idx]
    x0u = jnp.sum(jnp.conj(ha) * y0 + hb * jnp.conj(y1), axis=1)  # [B,P]
    x1u = jnp.sum(jnp.conj(ha) * y1 - hb * jnp.conj(y0), axis=1)
    G = jnp.sum(jnp.abs(ha) ** 2 + jnp.abs(hb) ** 2, axis=1)      # [B,P]
    s = 1.0 / np.sqrt(2.0)
    x0 = x0u / jnp.maximum(s * G, 1e-12)
    x1 = x1u / jnp.maximum(s * G, 1e-12)
    x = jnp.stack([x0, x1], axis=-1).reshape(y.shape[0], -1)
    csi = (0.5 * G)[..., None].repeat(2, -1).reshape(y.shape[0], -1)
    return x, csi


@lru_cache(maxsize=None)
def build_rx(psdef: PacketSizesDef, network_id: int, plcf_type: int,
             chestim_mode: str = "lr_t", freq_kind: str = "wiener",
             time_kind: str = "linear", dd_passes: int = 0,
             n_iter: int = 6, est_sto: bool = True, est_cfo: bool = True,
             genie: bool = False):
    """Returns a jitted rx(iq [B, N_RX, N_samples_packet], noise_var) -> dict.

    genie=True: diagnostic mode — rx takes a third argument
    h_genie [B, N_RX, N_TS, S, N_occ] (the TRUE channel, e.g. from
    simulation.channels.doubly_selective_genie) and uses it in place of the
    DRS ZF + Wiener/time interpolation; CFO/STO estimation is bypassed.
    Separates channel-estimation loss from channel outage in fading PER
    curves (the reference has no genie mode; its lr_t quality is only
    PER-visible).

    noise_var is the time-domain per-sample noise variance (used only for LLR
    scaling; max-log decoding is scale-invariant, so a rough estimate is fine).

    est_cfo: residual fractional CFO re-estimated from STF pattern-pair
    autocorrelation and derotated over the whole packet (reference
    rx_synced.cpp:503-619 run_stf re-estimation, ON in the shipped build).
    est_sto: fractional STO estimated as the phase slope across DRS ZF
    estimates and removed as a per-subcarrier derotation ramp before channel
    interpolation (reference offsets/estimator_sto.cpp:47-171, ON).
    """
    if genie:
        est_sto = est_cfo = False
    luts = get_packet_luts(psdef)
    ps = luts.ps
    q = ps.numerology
    N, S, cp = q.N_b_DFT, ps.N_PACKET_symb, q.N_b_CP
    N_occ = q.N_b_OCC
    N_TS, N_SS = ps.tm_mode.N_TS, ps.tm_mode.N_SS
    N_DF = ps.N_DF_symb
    plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
    rx_scale = np.sqrt(N_occ) / N

    # Wiener-preset bank, selected on TWO axes at runtime: estimated SNR
    # (smoothing strength; reference rx_synced.cpp:863-891 picks by SNR
    # alone) and measured frequency SELECTIVITY (assumed delay window).
    # The second axis is the improvement over the reference: an SNR-only
    # pick can't distinguish 'low SNR because noise' (wants narrow/smooth)
    # from 'low SNR because fade in a selective channel' (needs the wide
    # window), which produced the r03 SNR-independent fading floor.
    if freq_kind == "wiener":
        # two regimes on the measured-selectivity axis (the axis itself is
        # the improvement over the reference's SNR-only pick):
        #  * non-selective: SNR-matched NARROW Wiener smoothing (noise
        #    suppression is all that matters on a flat comb),
        #  * selective: wide-window Wiener at low SNR, clamped LINEAR at
        #    mid/high SNR.  Measured (r05, doubly 363ns/222Hz MCS4 aligned):
        #    the wide uniform-PDP Wiener's prior bias dominates once pilot
        #    noise is small — linear (locally unbiased) halves the PER at
        #    24-28 dB (0.030 vs 0.057); at low SNR the Wiener's noise
        #    suppression still wins.
        tau_narrow = min(tau for tau, _ in WIENER_PRESETS)
        Wf_bank = [freq_interp_matrices(psdef.b, "wiener", tau_narrow, sn,
                                        centered=est_sto, u=psdef.u)
                   for _, sn in WIENER_PRESETS]                   # narrow set
        Wf_bank += [freq_interp_matrices(psdef.b, "wiener", 1000e-9,
                                         WIENER_PRESETS[0][1],
                                         centered=est_sto, u=psdef.u),
                    freq_interp_matrices(psdef.b, "linear"),
                    freq_interp_matrices(psdef.b, "linear")]      # selective
        preset_snrs = np.array([sn for _, sn in WIENER_PRESETS], np.float32)
    else:
        Wf_bank = [freq_interp_matrices(psdef.b, freq_kind)]
        preset_snrs = np.zeros(1, np.float32)
    combs = comb_offsets(psdef.u, psdef.b, S, N_TS)               # [T,n_symb]
    Tm = time_interp_matrix(psdef.u, psdef.b, S, N_TS, chestim_mode)  # [T,S,n]
    # Doppler (nu) axis of the channel statistics: a bank of time-Wiener
    # interpolators over Jakes-correlated presets, selected by the measured
    # DRS-step correlation (reference statistics are (nu_max, tau_rms, SNR)
    # triples, rx_synced_param.hpp:216-232; r04 time interp was plain
    # linear — at f_D = 222 Hz that left a 12x estimated-vs-genie PER gap)
    Tm_bank = [Tm]
    rho_bounds = np.zeros(0, np.float32)
    if chestim_mode == "lr_t" and time_kind == "wiener":
        from ..sections.part3.drs import nof_drs_symbols_per_ts
        if nof_drs_symbols_per_ts(psdef.u, S, N_TS) >= 2:
            Tm_bank = [wiener_time_matrix(psdef.u, psdef.b, S, N_TS, nu)
                       for nu in NU_TIME_PRESETS]
            # preset selection happens in rho space (the measured DRS-step
            # correlation): boundaries = midpoints of the presets' own
            # J0(2 pi nu N_step) values, rho descending with nu
            rho_p = _j0(2.0 * np.pi * np.asarray(NU_TIME_PRESETS)
                        * get_N_step(N_TS))
            rho_bounds = ((rho_p[1:] + rho_p[:-1]) / 2.0).astype(np.float32)

    # STF pattern-pair layout for residual CFO (phy/sync.py convention)
    P_stf = 16 * psdef.b
    n_pat = n_stf_patterns(psdef.u)
    cov = cover_sequence(psdef.u)
    w_pat = (cov[:-1] * cov[1:]).astype(np.float32)               # [n_pat-1]

    # numpy closures: embedded as jit constants at trace time
    pcc_lin = np.asarray(luts.pcc_lin)
    pdc_lin = np.asarray(luts.pdc_lin)
    drs_lin = np.asarray(luts.drs_lin)
    drs_conj = np.conj(luts.drs_vals_per_ts)
    pcc_locc = np.asarray(luts.pcc_locc)
    pdc_locc = np.asarray(luts.pdc_locc)
    n4 = N_occ // 4
    n_drs_symb = luts.n_drs_symb
    N_step_drs = get_N_step(N_TS)

    if N_TS > 1:
        pcc_tsa, pcc_tsb = _pair_ts(98, N_TS)
        if N_SS == 1:
            pdc_tsa, pdc_tsb = _pair_ts(ps.N_PDC_subc, N_TS)

    # absolute subcarrier (relative to DC) of every gathered cell, for the
    # fractional-STO derotation ramp (estimator_sto.cpp apply_full_phase_rotation)
    sc_drs = ((drs_lin % N) - N // 2).astype(np.float32)          # [T, ns*n4]
    sc_drs = sc_drs.reshape(N_TS, n_drs_symb, n4)
    # pairwise products are valid only for 4-subcarrier spacing (the pair
    # crossing DC spans 5; reference handles the analogous STF center pair
    # by angle-halving, estimator_sto.cpp:131-143 — here it is masked out)
    pair_ok = (np.diff(sc_drs, axis=-1) == 4).astype(np.float32)  # [T,ns,n4-1]

    @jax.jit
    def rx(iq: jax.Array, noise_var, h_genie=None) -> dict:
        B, R = iq.shape[0], iq.shape[1]
        nv_bin = noise_var * N_occ / N

        # ---- residual fractional CFO from STF pattern pairs, derotate packet.
        # Two baselines with progressive unwrapping: lag P (unambiguous,
        # noisy) then lag 3P (3x less slope noise, disambiguated by the
        # first) — the lag-P-only estimate's noise, integrated over the
        # packet, aliased past the DRS refinement's +-pi/(N_step*(N+cp))
        # window at low SNR and cost ~5 dB at the MCS1 waterfall.
        if est_cfo:
            stf_t = iq[..., :n_pat * P_stf].reshape(B, R, n_pat, P_stf)
            qq = jnp.sum(stf_t[:, :, :-1] * jnp.conj(stf_t[:, :, 1:])
                         * jnp.asarray(w_pat)[None, None, :, None],
                         axis=(1, 2, 3))                          # [B]
            cfo_a = -jnp.angle(qq) / P_stf
            lag = 3
            w3 = (cov[:-lag] * cov[lag:]).astype(np.float32)
            q3 = jnp.sum(stf_t[:, :, :-lag] * jnp.conj(stf_t[:, :, lag:])
                         * jnp.asarray(w3)[None, None, :, None],
                         axis=(1, 2, 3))                          # [B]
            r3 = jnp.angle(q3 * jnp.exp(1j * cfo_a * (lag * P_stf)))
            cfo_res = cfo_a - r3 / (lag * P_stf)
            iq = iq * _exp_ramp(-cfo_res, iq.shape[-1])[:, None, :]
        else:
            cfo_res = jnp.zeros((B,), jnp.float32)

        # ---- CP strip + batched FFT of the data field
        df = iq[..., ps.N_samples_STF:ps.N_samples_STF + N_DF * (N + cp)]
        sym = df.reshape(B, R, N_DF, N + cp)[..., cp:]
        Y = jnp.fft.fftshift(jnp.fft.fft(sym, axis=-1), axes=-1) * rx_scale

        # ---- full-packet grid (symbol 0 = STF slot stays zero)
        grid = jnp.zeros((B, R, S, N), dtype=jnp.complex64)
        grid = grid.at[:, :, 1:1 + N_DF].set(Y.astype(jnp.complex64))
        gf = grid.reshape(B, R, S * N)

        # ---- DRS ZF estimates -> interpolated channel [B,R,T,S*N_occ]
        h_zf = gf[..., drs_lin] * drs_conj[None, None]            # [B,R,T,ns*n4]
        h_zf = h_zf.reshape(B, R, N_TS, n_drs_symb, n4)

        # ---- residual-CFO refinement from DRS symbol-pair phase progression
        # (the reference's estimator_cfo_t, declared but compile-DISABLED in
        # its shipped build — implemented here because it matters: the
        # STF-only re-estimate above has a 16*b-sample baseline and its
        # noise, derotated over the whole packet, cost ~5 dB at the MCS1
        # waterfall; consecutive DRS symbols are N_step*(N+cp) samples apart
        # = a 22x longer baseline. Applied as per-symbol common phase on the
        # grid so pilots and data stay consistent; chestim absorbs the rest.)
        if est_cfo and n_drs_symb >= 2:
            prod = jnp.sum(h_zf[..., 1:, :] * jnp.conj(h_zf[..., :-1, :]),
                           axis=(1, 2, 4))                        # [B, ns-1]
            dphi = jnp.angle(jnp.sum(prod, axis=-1))              # [B]
            cfo2 = dphi / (N_step_drs * (N + cp))
            t_sym = np.arange(S, dtype=np.float32) * (N + cp)
            ph = jnp.exp(-1j * cfo2[:, None] * jnp.asarray(t_sym))
            grid = grid * ph[:, None, :, None].astype(jnp.complex64)
            gf = grid.reshape(B, R, S * N)
            h_zf = (gf[..., drs_lin] * drs_conj[None, None]).reshape(
                B, R, N_TS, n_drs_symb, n4)
            cfo_res = cfo_res + cfo2
        if genie:
            # true channel provided: bypass ZF pilots + interpolation
            cf = h_genie.reshape(B, R, N_TS, S * N_occ).astype(jnp.complex64)
            theta = jnp.zeros((B,), jnp.float32)
            sto_frac = jnp.zeros((B,), jnp.float32)
            spn = jnp.mean(jnp.abs(h_genie) ** 2, axis=(1, 2, 3, 4))
            snr_db = 10.0 * jnp.log10(
                jnp.maximum(spn / jnp.maximum(nv_bin, 1e-12), 1e-10))
            h_end = h_genie[..., S - 1, 0::4]                     # [B,R,T,n4]
            h_cells = h_end[..., :n4 // 4 * 4].reshape(
                B, R, N_TS, 4, -1).mean(-1)
            return _finish(iq, gf, cf, theta, sto_frac, cfo_res, snr_db,
                           h_cells, nv_bin, B,
                           jnp.zeros((B,), bool))

        # ---- fractional STO: phase slope across DRS pilots, remove the
        # per-subcarrier ramp from pilots and data before interpolation
        if est_sto:
            qs = jnp.sum(h_zf[..., 1:] * jnp.conj(h_zf[..., :-1])
                         * jnp.asarray(pair_ok)[None, None],
                         axis=(1, 2, 3, 4))                       # [B]
            theta = jnp.angle(qs) / 4.0                           # rad/subcarrier
            h_zf = h_zf * jnp.exp(
                -1j * theta[:, None, None, None, None]
                * jnp.asarray(sc_drs)[None, None])
        else:
            theta = jnp.zeros((B,), jnp.float32)
        # + = packet arrives later than the FFT window (reference
        # estimator_sto.cpp get_fractional_sto_in_samples sign convention)
        sto_frac = -theta * N / (2.0 * np.pi)                     # in samples

        # ---- preamble/DRS SNR estimate (reference estimator_snr.cpp:84-144:
        # S+N = ||h_zf||^2 over pilots, noise from differences of
        # neighbouring h_zf). FOURTH-order differences instead of the
        # reference's first-order pairs: d4 = h[k+2] - 4 h[k+1] + 6 h[k]
        # - 4 h[k-1] + h[k-2] cancels channel variation up to cubic across
        # the comb, so a frequency-selective channel no longer counts as
        # noise — the r03 fading floor traced to exactly this chain:
        # selectivity inflated the noise estimate (first-order saturated
        # ~12 dB, second-order ~24 dB at 363 ns), the estimated SNR never
        # reached the wide-delay high-SNR Wiener preset, and the narrow
        # low-SNR matrix filtered out real channel selectivity at any true
        # SNR. E|d4|^2 = 70 sigma^2 for white noise (sum of C(4,k)^2).
        spn = jnp.mean(jnp.abs(h_zf) ** 2, axis=(1, 2, 3, 4))
        d4 = (h_zf[..., 4:] - 4.0 * h_zf[..., 3:-1] + 6.0 * h_zf[..., 2:-2]
              - 4.0 * h_zf[..., 1:-3] + h_zf[..., :-4])
        nois = jnp.mean(jnp.abs(d4) ** 2, axis=(1, 2, 3, 4)) / 70.0
        snr_lin = jnp.maximum(spn - nois, 1e-10) / jnp.maximum(nois, 1e-10)
        snr_db = 10.0 * jnp.log10(snr_lin)

        # ---- packet-end DRS wideband 4-cell condensation for the MIMO
        # estimator (reference estimator_mimo.cpp:80-250; search runs
        # host-side in phy.mimo.reports_from_cells)
        h_end = h_zf[..., -1, :]                                  # [B,R,T,n4]
        h_cells = h_end[..., :n4 // 4 * 4].reshape(
            B, R, N_TS, 4, -1).mean(-1)                           # [B,R,T,4]

        # ---- frequency interpolation with SNR-selected Wiener preset:
        # interpolate with every preset matrix (cheap matmuls), one-hot mix
        # by closest preset SNR (reference rx_synced.cpp:863-891)
        def interp(Wf):
            hf = jnp.zeros((B, R, N_TS, n_drs_symb, N_occ), jnp.complex64)
            for c in np.unique(np.asarray(combs)):
                hc = jnp.einsum("brtnp,kp->brtnk", h_zf, jnp.asarray(Wf[c]))
                mask = jnp.asarray((combs == c))[None, None, :, :, None]
                hf = jnp.where(mask, hc, hf)
            return hf
        # ---- Doppler axis: measured DRS-step correlation magnitude
        # rho = |sum h[n+1] h[n]*| / (sum |h[n]|^2 - noise bias); frequency
        # selectivity cancels per-subcarrier, residual CFO is a common
        # rotation (coherent across pairs), noise debiases out of the
        # numerator. Selects the time-Wiener preset (bank built above).
        if len(Tm_bank) > 1:
            qt = jnp.sum(h_zf[..., 1:, :] * jnp.conj(h_zf[..., :-1, :]),
                         axis=(1, 2, 3, 4))                       # [B]
            d_t = jnp.sum(jnp.abs(h_zf[..., :-1, :]) ** 2,
                          axis=(1, 2, 3, 4))                      # [B]
            cnt = R * N_TS * (n_drs_symb - 1) * n4
            rho = jnp.abs(qt) / jnp.maximum(d_t - nois * cnt, 1e-12)
            idx_t = jnp.sum(rho[:, None] < jnp.asarray(rho_bounds)[None],
                            axis=1)                               # [B]
            sel_t = jax.nn.one_hot(idx_t, len(Tm_bank), dtype=jnp.complex64)

        selective = jnp.zeros((B,), bool)
        if len(Wf_bank) == 1:
            hf = interp(Wf_bank[0])
        else:
            snr_idx = jnp.argmin(jnp.abs(snr_db[:, None]
                                         - jnp.asarray(preset_snrs)[None]),
                                 axis=1)                          # [B]
            # selectivity axis: curvature power of the channel across the
            # pilot comb, noise-debiased (E|d2|^2 = 6 sigma^2 + |h''|^2;
            # a single tap at delay tau puts phi^4 here with
            # phi = 2 pi * 4 * tau * delta_f — 363 ns: 3.7e-3, 50 ns:
            # 1.3e-6; threshold 3e-4 ~ tau 200 ns)
            d2m = jnp.mean(jnp.abs(
                h_zf[..., 2:] - 2.0 * h_zf[..., 1:-1] + h_zf[..., :-2]
            ) ** 2, axis=(1, 2, 3, 4))
            c2 = jnp.maximum(d2m - 6.0 * nois, 0.0)
            selective = (c2 / jnp.maximum(spn, 1e-12)) > 3e-4     # [B]
            idx = snr_idx + 3 * selective.astype(snr_idx.dtype)
            sel = jax.nn.one_hot(idx, len(Wf_bank), dtype=jnp.complex64)
            hf = sum(sel[:, i, None, None, None, None] * interp(W)
                     for i, W in enumerate(Wf_bank))
        if len(Tm_bank) == 1:
            chest = jnp.einsum("tsn,brtnk->brtsk", jnp.asarray(Tm_bank[0]), hf)
        else:
            chest = sum(sel_t[:, i, None, None, None, None]
                        * jnp.einsum("tsn,brtnk->brtsk", jnp.asarray(Tmi), hf)
                        for i, Tmi in enumerate(Tm_bank))
        cf = chest.reshape(B, R, N_TS, S * N_occ)

        return _finish(iq, gf, cf, theta, sto_frac, cfo_res, snr_db,
                       h_cells, nv_bin, B, selective)

    def _finish(iq, gf, cf, theta, sto_frac, cfo_res, snr_db, h_cells,
                nv_bin, B, selective):

        # fractional-STO derotation applied ONCE on the grid via a [B, N]
        # per-subcarrier table (exp(-j theta (k - N/2))): the former
        # per-gathered-cell ramps evaluated ~33 M transcendentals per u8b16
        # batch where the table needs B*N; the grid multiply is
        # bandwidth-bound. Identical math: cell ramp = tbl[lin % N].
        R_ = gf.shape[1]
        ksc = jnp.arange(N, dtype=jnp.float32) - N // 2
        tbl = jnp.exp(-1j * theta[:, None] * ksc[None, :])         # [B,N]
        gf = (gf.reshape(B, R_, S, N)
              * tbl[:, None, None, :].astype(jnp.complex64)
              ).reshape(B, R_, S * N)

        # ---- PCC: combine, demap QPSK, blind decode both PLCF types
        y_pcc = gf[..., pcc_lin]                                   # [B,R,98]
        h_pcc = cf[..., pcc_locc]                                  # [B,R,T,98]
        if N_TS == 1:
            x_pcc, csi_pcc = _mrc(y_pcc, h_pcc[:, :, 0])
        else:
            x_pcc, csi_pcc = _alamouti(y_pcc, h_pcc, pcc_tsa, pcc_tsb)
        llr_pcc = demap_llr(x_pcc, csi_pcc, 2, nv_bin)
        a1, ok1, cl1, bf1 = pcc_decode(llr_pcc, 1, n_iter)
        a2, ok2, cl2, bf2 = pcc_decode(llr_pcc, 2, n_iter)

        # ---- PDC: combine, demap, turbo decode, TB CRC
        y_pdc = gf[..., pdc_lin]
        h_pdc = cf[..., pdc_locc]
        if N_TS == 1:
            x_pdc, csi_pdc = _mrc(y_pdc, h_pdc[:, :, 0])
            # ---- decision-directed chestim refinement (doubly-selective
            # tracking): every PDC cell becomes a pilot. h ~ y conj(dec)
            # aggregated as WLS (weights |dec|^2) over a 9-tap frequency
            # window within each symbol — per-symbol time resolution, which
            # DRS interpolation cannot give (DRS symbols are N_step apart).
            # Gated by the measured-selectivity flag: on a flat channel the
            # first-pass Wiener chest is already near-optimal and decision
            # noise would only hurt. No reference counterpart (the
            # reference's chestim is pilot-only, channel_lut.cpp).
            h1 = h_pdc[:, :, 0]
            sym_onehot = None
            for _ in range(dd_passes):
                from .modulation import hard_decision
                dec = hard_decision(x_pdc, ps.mcs.N_bps)          # [B,n]
                # residual of the DD estimate RELATIVE to the chest:
                # r = sum_cells y conj(dec) conj(h_chest) per symbol has
                # the phase of (h_true / h_chest) -> a per-symbol common
                # phase correction that adds symbol-rate time resolution
                # without giving up the chest's noise suppression
                resid = jnp.sum(y_pdc * jnp.conj(dec)[:, None, :]
                                * jnp.conj(h1), axis=1)           # [B,n]
                if sym_onehot is None:
                    sym_idx = (np.asarray(pdc_lin) // N).astype(np.int64)
                    oh = np.zeros((sym_idx.size, S), np.float32)
                    oh[np.arange(sym_idx.size), sym_idx] = 1.0
                    sym_onehot = jnp.asarray(oh)                  # [n,S]
                r_sym = resid @ sym_onehot.astype(jnp.complex64)  # [B,S]
                mag = jnp.abs(r_sym)
                ph = r_sym / jnp.maximum(mag, 1e-20)
                ph_cell = ph @ sym_onehot.T.astype(jnp.complex64)  # [B,n]
                h1 = h1 * ph_cell[:, None, :]
                x_dd, csi_dd = _mrc(y_pdc, h1)
                use = selective[:, None]
                x_pdc = jnp.where(use, x_dd, x_pdc)
                csi_pdc = jnp.where(use, csi_dd, csi_pdc)
        elif N_SS == 1:
            x_pdc, csi_pdc = _alamouti(y_pdc, h_pdc, pdc_tsa, pdc_tsb)
        else:
            # spatial multiplexing: MMSE equalize, then undo the TX's serial
            # round-robin symbol->stream mapping (tx.py: stream s carries
            # serial symbol i*N_SS+s at cell i)
            xs, sinr = _mmse(y_pdc, h_pdc, nv_bin, N_SS)    # [B,S,n]
            x_pdc = xs.transpose(0, 2, 1).reshape(xs.shape[0], -1)
            csi_pdc = sinr.transpose(0, 2, 1).reshape(xs.shape[0], -1)
        if N_SS > 1:
            # csi already IS the post-equalization SINR: demap at unit noise
            llr_pdc = demap_llr(x_pdc, csi_pdc, ps.mcs.N_bps, 1.0)
        else:
            llr_pdc = demap_llr(x_pdc, csi_pdc, ps.mcs.N_bps, nv_bin)
        tb, tb_ok = pdc_decode(llr_pdc, plan, network_id, plcf_type,
                               n_iter=n_iter)

        return {
            "plcf1": a1, "plcf1_ok": ok1, "plcf1_cl": cl1, "plcf1_bf": bf1,
            "plcf2": a2, "plcf2_ok": ok2, "plcf2_cl": cl2, "plcf2_bf": bf2,
            "tb": tb, "tb_ok": tb_ok, "snr_db": snr_db,
            "h_cells": h_cells, "x_pdc": x_pdc,
            "sto_frac": sto_frac.astype(jnp.float32),
            "cfo_res": cfo_res.astype(jnp.float32),
        }

    return rx
