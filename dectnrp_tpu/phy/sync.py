"""STF synchronization: detection, coarse/fine peak, CFO, N_eff_TX.

TPU-native counterpart of the reference sync pipeline
(lib/src/phy/rx/sync/sync_chunk.cpp:146-278):

  autocorrelator_detection -> autocorrelator_peak -> [coarse_peak_f_domain]
  -> crosscorrelator (fine STO + N_eff_TX)

Instead of a per-step streamed search with O(1) moving sums
(autocorrelator_detection.cpp:236-243, movsum.hpp), the whole chunk's
pattern-lag autocorrelation metric is computed at once from cumulative sums
(one elementwise multiply + a handful of shifted-slice adds), the coarse peak
is a smoothed argmax, and the fine search is an FFT cross-correlation of the
coarse-peak segment against all N_eff_TX templates at once (reference
crosscorrelator.cpp:122-249 does this as search_length x antennas x
templates separate VOLK dot products).

The STF cover sequence (stf.cpp cover-sequence weights) enters as the +-1
pairwise-product weights of the pattern-lag sums, exactly like movsum_uw_t.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sections.part3 import phyres
from ..sections.part3.stf import cover_sequence, n_stf_patterns, stf_freq_grid
from ..sections.part3.transmission_packet_structure import get_N_samples_STF


@dataclass(frozen=True)
class SyncParams:
    """Runtime equivalents of the reference's compile-time sync_param.hpp.

    metric_threshold: detection gate (reference RX_SYNC_PARAM metric in
    [0.25, 1.5], sync_param.hpp:118-173). rms gates default off (simulator).
    """
    metric_threshold: float = 0.25
    metric_max: float = 1.5
    rms_min: float = 0.0        # 0 disables the RMS window gate
    rms_max: float = float("inf")
    smooth_left: int = 7        # metric smoothing, x b samples (peak search)
    smooth_right: int = 1
    fine_search_half: int = 16  # x b samples around the coarse peak
    est_beta_icfo: bool = False # f-domain beta + integer-CFO stage (the
                                # reference declares but disables this,
                                # coarse_peak_f_domain.cpp:94-201)


@lru_cache(maxsize=None)
def stf_time_template(u: int, b: int, N_eff_TX: int) -> np.ndarray:
    """Unit-energy time-domain STF (pattern IFFT, n_pat reps, cover sequence).

    Mirrors the TX STF assembly (phy/tx.py) / reference stf_template.cpp.
    """
    N = 64 * b
    grid = stf_freq_grid(b, N_eff_TX)
    body = np.fft.ifft(np.fft.ifftshift(grid))
    pattern = body[: 16 * b]
    cover = cover_sequence(u)
    t = np.concatenate([c * pattern for c in cover])
    return (t / np.linalg.norm(t)).astype(np.complex64)


def _shift_sum(S: jax.Array, off_lo: int, off_hi: int, n_out: int) -> jax.Array:
    """S[..., t+off_hi] - S[..., t+off_lo] for t in [0, n_out)."""
    return jax.lax.dynamic_slice_in_dim(S, off_hi, n_out, -1) - \
        jax.lax.dynamic_slice_in_dim(S, off_lo, n_out, -1)


def _prefix0(x: jax.Array, blk: int = 512) -> jax.Array:
    """Exclusive prefix sum along the last axis, blocked two-level form.

    Equivalent to concat([0, cumsum(x)]): in-block cumsums over `blk` lanes
    plus a (T/blk)-length scan of block totals instead of XLA's log-depth
    lowering of the full T-length cumsum. Whether the blocked form beats a
    plain cumsum on a GPU is for the benchmark's trace to say.
    """
    T = x.shape[-1]
    nb = -(-T // blk)
    pad = nb * blk - T
    xb = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    xb = xb.reshape(*x.shape[:-1], nb, blk)
    local = jnp.cumsum(xb, axis=-1)                       # inclusive in-block
    totals = local[..., -1]                               # [.., nb]
    base = jnp.cumsum(totals, axis=-1) - totals           # exclusive blocks
    incl = (local + base[..., None]).reshape(*x.shape[:-1], nb * blk)[..., :T]
    zero = jnp.zeros_like(incl[..., :1])
    return jnp.concatenate([zero, incl], axis=-1)


def _detect_xla(x, P: int, w: np.ndarray, n_t: int, norm: float, sl: int,
                sr: int, params: SyncParams):
    """STF detection metric over a whole chunk from prefix sums.

    x [B, R, T]: pattern-lag (P) autocorrelation with the +-1 cover weights
    w [n_pat - 1], window power, their antenna-combined metric, the gate
    and its (sl, sr) moving average. Returns (sm, metric, metric_g, rms, Cs)
    over the n_t valid start positions.
    """
    R = x.shape[1]
    n_pat = len(w) + 1
    # ---- pattern-lag autocorrelation over the whole chunk
    p = x[..., :-P] * jnp.conj(x[..., P:])                        # [B,R,T-P]
    Sp = _prefix0(p)
    C = sum(w[j] * _shift_sum(Sp, j * P, (j + 1) * P, n_t)
            for j in range(n_pat - 1))                            # [B,R,n_t]
    pw = jnp.abs(x) ** 2
    Sw = _prefix0(pw)
    P2 = _shift_sum(Sw, 0, n_pat * P, n_t)                        # [B,R,n_t]

    # combine antennas before the gates (reference: per-antenna metrics,
    # antenna-limit option; summing is the batched equivalent)
    Cs = jnp.sum(C, axis=1)
    P2s = jnp.sum(P2, axis=1)
    metric = norm * jnp.abs(Cs) / jnp.maximum(P2s, 1e-20)         # [B,n_t]
    rms = jnp.sqrt(P2s / (n_pat * P * R))

    gate = (metric > params.metric_threshold) & (metric < params.metric_max)
    if params.rms_min > 0.0:
        gate &= (rms > params.rms_min) & (rms < params.rms_max)
    metric_g = jnp.where(gate, metric, 0.0)

    k = sl + sr + 1
    Sm = _prefix0(jnp.pad(metric_g, ((0, 0), (sl, sr))))
    sm = (Sm[..., k:] - Sm[..., :-k]) / k                         # [B,n_t]
    return sm, metric, metric_g, rms, Cs


@lru_cache(maxsize=None)
def build_sync(u: int, b: int, T: int,
               neff_candidates: tuple[int, ...] = (1, 2, 4, 8),
               params: SyncParams = SyncParams(),
               max_peaks: int = 1):
    """Returns jitted sync(iq [B, N_RX, T]) -> report dict.

    max_peaks=1 (default): one packet per chunk, report fields all [B]:
    detected, t_fine (STF start, samples), cfo (rad/sample), n_eff_tx,
    metric, rms.

    max_peaks=K>1: up to K packets per chunk via iterative peak masking
    (the reference sync_chunk keeps searching after each hit,
    sync_chunk.cpp:146-278); report fields become [B, K], ordered by
    descending smoothed metric.  After each peak, +-1 STF around it is
    masked before the next argmax (the baton's unique-time filter,
    worker_pool.cpp:299-324, applied inside the kernel).
    """
    P = 16 * b                           # STF pattern length
    n_pat = n_stf_patterns(u)
    L = n_pat * P                        # full STF length
    assert get_N_samples_STF(u, b) == L
    cover = cover_sequence(u)
    w = (cover[:-1] * cover[1:]).astype(np.float32)   # pairwise +-1 weights
    n_t = T - L - P                      # valid metric support
    assert n_t > 0, "chunk shorter than STF + one pattern"
    half = params.fine_search_half * b
    # pre-conjugated: the fine-search einsum computes <win, tmpl> = sum win*conj(tmpl)
    templates = np.conj(np.stack(
        [stf_time_template(u, b, m) for m in neff_candidates], axis=1))  # [L, M]
    sl, sr = params.smooth_left * b, params.smooth_right * b
    norm = n_pat / (n_pat - 1)           # metric -> 1 for ideal periodic STF

    @jax.jit
    def sync(iq: jax.Array) -> dict:
        B, R = iq.shape[0], iq.shape[1]
        x = iq
        sm, metric, metric_g, rms, Cs = _detect_xla(
            x, P, w, n_t, norm, sl, sr, params)

        # ---- coarse peaks: K argmax rounds over the smoothed metric with
        # +-1 STF masking between rounds (multi-packet-per-chunk search)
        tt = jnp.arange(n_t)
        sm_cur = sm
        t_list = []
        for _ in range(max_peaks):
            t_k = jnp.argmax(sm_cur, axis=-1)                     # [B]
            t_list.append(t_k)
            if max_peaks > 1:
                sm_cur = jnp.where(jnp.abs(tt[None, :] - t_k[:, None]) < L,
                                   -1.0, sm_cur)
        t_coarse = jnp.stack(t_list, axis=-1)                     # [B,K]
        # both the instantaneous and smoothed metric must clear the gate --
        # the batched equivalent of the reference's rising-metric streak
        # (sync_param.hpp:118-173): noise rarely sustains the metric over
        # the smoothing window, a real STF plateau (width ~pattern) does
        sm_pk = jnp.take_along_axis(sm, t_coarse, -1)
        detected = (
            (jnp.take_along_axis(metric_g, t_coarse, -1)
             > params.metric_threshold)
            & (sm_pk > params.metric_threshold))                  # [B,K]
        peak_metric = jnp.take_along_axis(metric, t_coarse, -1)
        peak_rms = jnp.take_along_axis(rms, t_coarse, -1)
        c_pk = jnp.take_along_axis(Cs, t_coarse, -1)              # [B,K]

        # ---- fractional CFO from the autocorrelation phase at each peak
        # x[t]*conj(x[t+P]) rotates by -cfo*P under x = s*exp(j*cfo*n)
        cfo = -jnp.angle(c_pk) / P                                # rad/sample

        # ---- fine peak + N_eff_TX: FFT-based cross-correlation against all
        # templates. seg_len = L + D - 1 exactly, so a single nfft >= seg_len
        # circular correlation equals the valid linear one — replaces the
        # windowed-gather matmul formulation that materialized [R, D, L]
        # (151 MB at u=8 b=16) with (R + R*M) FFTs per peak (reference
        # crosscorrelator.cpp:122-249 does D x M x R separate dot products)
        seg_len = L + 2 * half
        D = 2 * half + 1
        nfft = 1 << int(np.ceil(np.log2(seg_len)))
        # xc[d, m] = sum_l seg[d+l] * templates[l, m]
        #          = IFFT(FFT(seg) * conj(FFT(conj(templates))))[d]
        Gc = np.conj(np.fft.fft(np.conj(templates), n=nfft, axis=0))  # [nfft,M]
        t0 = jnp.clip(t_coarse - half, 0, T - seg_len)            # [B,K]

        def fine_one(xb, t0b, cfob):
            seg = jax.lax.dynamic_slice_in_dim(xb, t0b, seg_len, -1)  # [R,seg]
            n = jnp.arange(seg_len, dtype=jnp.float32)
            seg = seg * jnp.exp(-1j * cfob * n)[None, :]
            A = jnp.fft.fft(seg, n=nfft, axis=-1)                     # [R,nfft]
            xc = jnp.fft.ifft(A[:, :, None] * jnp.asarray(Gc)[None],
                              axis=1)[:, :D]                          # [R,D,M]
            pw = jnp.abs(seg) ** 2
            cs = jnp.cumsum(pw, axis=-1)
            cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], axis=-1)
            e_win = cs[:, L:L + D] - cs[:, :D]                        # [R,D]
            m = jnp.sum(jnp.abs(xc) ** 2 / jnp.maximum(e_win, 1e-20)[..., None],
                        axis=0)                                       # [D,M]
            flat = jnp.argmax(m)
            d_best, m_best = flat // m.shape[1], flat % m.shape[1]
            return t0b + d_best, m_best

        fine_k = jax.vmap(fine_one, in_axes=(None, 0, 0))             # over K
        t_fine, m_idx = jax.vmap(fine_k)(x, t0, cfo)                  # [B,K]
        n_eff = jnp.asarray(np.array(neff_candidates))[m_idx]

        if params.est_beta_icfo:
            bi = build_beta_icfo(u, b)
            Nfft = 64 * b

            def bi_one(xb, tf):
                seg = jax.lax.dynamic_slice_in_dim(
                    xb, jnp.clip(tf, 0, T - Nfft), Nfft, -1)
                return bi(seg)

            beta_e, icfo_e = jax.vmap(jax.vmap(bi_one, in_axes=(None, 0)))(
                x, t_fine)                                            # [B,K]

        out = {
            "detected": detected,
            "t_fine": t_fine.astype(jnp.int32),
            "t_coarse": t_coarse.astype(jnp.int32),
            "cfo": cfo.astype(jnp.float32),
            "n_eff_tx": n_eff.astype(jnp.int32),
            "metric": peak_metric.astype(jnp.float32),
            "rms": peak_rms.astype(jnp.float32),
        }
        if params.est_beta_icfo:
            out["beta"] = beta_e.astype(jnp.int32)
            out["cfo_int"] = icfo_e.astype(jnp.int32)
        if max_peaks == 1:
            out = {kk: v[..., 0] for kk, v in out.items()}
        return out

    return sync


@lru_cache(maxsize=None)
def build_beta_icfo(u: int, b_max: int,
                    candidates: tuple[int, ...] = (1, 2, 4, 8, 12, 16),
                    shifts: tuple[int, ...] = (-1, 0, 1, 2)):
    """f-domain coarse-peak stage: joint beta + integer-CFO estimation.

    The reference DECLARES this stage but ships it compile-disabled
    (coarse_peak_f_domain.cpp:94-201 beta by sideband-power expansion;
    integer CFO is an #error stub) — implemented here as a capability the
    reference lacks. Physics: at the b_max hardware rate every beta's STF
    occupies bins k ≡ 0 (mod 4), 4 <= |k| <= 28*beta of the 64*b_max FFT
    (subcarrier spacing is set by u alone), so one windowed FFT at the
    coarse peak yields both the bandwidth (how far the comb extends) and
    the integer CFO (how far the comb is shifted). The comb's period of 4
    makes shifts s and s±4 fully aliased (and ±2 mutually aliased up to a
    few band-edge bins whose sign would be decided by noise), so the
    candidate `shifts` window must span at most ONE comb period; the
    default is the asymmetric {-1, 0, +1, +2}.

    Returns jitted est(seg [R, 64*b_max] starting at the STF start) ->
    (beta [], s [] in bins): per candidate (beta, s) the comb's excess
    power over the in-band off-comb mean is scored; s is the global argmax
    and beta the smallest candidate scoring >= 90% of the maximum at that
    s (a larger-than-true beta only adds noise bins, so the score
    plateaus at the true beta).
    """
    Nfft = 64 * b_max
    dc = Nfft // 2
    cands = tuple(c for c in candidates if c <= b_max)
    P = 16 * b_max
    cov = cover_sequence(u)[:4]
    # precompensate the cover-sequence signs of the 4 patterns in the window
    # (the window spans exactly 4 STF patterns: 64 b = 4 * 16 b), else the
    # ±1 modulation smears the comb off the ≡0 (mod 4) bins
    decov = np.repeat(cov, P).astype(np.float32)
    assert max(shifts) - min(shifts) < 4, "shift window spans a comb period"
    shifts = np.asarray(shifts, np.int64)

    cell_sets = []
    for c in cands:
        k = np.array([kk for kk in range(-28 * c, 28 * c + 1, 4) if kk != 0])
        cell_sets.append(dc + k)

    @jax.jit
    def est(seg: jax.Array):
        seg = seg * jnp.asarray(decov)[None, :]
        S = jnp.fft.fftshift(jnp.fft.fft(seg, axis=-1), axes=-1)
        Pw = jnp.sum(jnp.abs(S) ** 2, axis=0)               # [Nfft]
        cs = jnp.cumsum(Pw)
        cs = jnp.concatenate([jnp.zeros((1,), cs.dtype), cs])
        X = []
        for c, cells in zip(cands, cell_sets):
            idx = jnp.asarray(cells)[:, None] + jnp.asarray(shifts)[None, :]
            comb = jnp.sum(Pw[idx], axis=0)                 # [n_shifts]
            lo = dc - 28 * c + jnp.asarray(shifts)
            hi = dc + 28 * c + jnp.asarray(shifts)
            band = cs[hi + 1] - cs[lo]                      # [n_shifts]
            n_cells = cells.size
            n_off = (56 * c + 1) - n_cells
            mu_off = (band - comb) / n_off
            X.append(comb - n_cells * mu_off)
        X = jnp.stack(X)                                    # [n_cand, n_shifts]
        s_idx = jnp.argmax(jnp.max(X, axis=0))
        col = X[:, s_idx]
        good = col >= 0.9 * jnp.max(col)
        # smallest candidate on the plateau
        b_idx = jnp.argmax(good)
        beta = jnp.asarray(np.asarray(cands, np.int32))[b_idx]
        return beta, jnp.asarray(shifts.astype(np.int32))[s_idx]

    return est


@lru_cache(maxsize=None)
def build_rx_stream(psdef, network_id: int, plcf_type: int, T: int, **rx_kw):
    """rx over an unaligned stream: sync-report-driven slice + CFO derotation.

    Returns jitted f(iq [B, N_RX, T], t0 [B], cfo [B], noise_var) -> rx dict.
    Bridges sync output into the aligned whole-packet rx (phy/rx.py).
    """
    from ..sections.part3.packet_sizes import get_packet_sizes
    from .rx import build_rx

    ps = get_packet_sizes(psdef)
    n_pkt = ps.N_samples_packet
    assert T >= n_pkt
    rx = build_rx(psdef, network_id, plcf_type, **rx_kw)

    @jax.jit
    def rx_stream(iq, t0, cfo, noise_var):
        from .rx import _exp_ramp
        ramp = _exp_ramp(-cfo, n_pkt)                      # [B, n_pkt]

        def slice_one(xb, t0b, rb):
            seg = jax.lax.dynamic_slice_in_dim(
                xb, jnp.clip(t0b, 0, T - n_pkt), n_pkt, -1)
            return seg * rb[None, :]
        aligned = jax.vmap(slice_one)(iq, t0, ramp)
        return rx(aligned.astype(jnp.complex64), noise_var)

    return rx_stream
