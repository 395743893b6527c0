"""Polyphase fractional resampler: the DECT (n x 1.728 Ms/s) <-> SDR
(n x 1.92 / 30.72M-family) rate bridge.

TPU-native counterpart of reference lib/src/phy/resample/resampler.cpp:
same merged anti-image/anti-alias Kaiser LPF (f_pass/f_stop/att specs from
resampler_param.hpp:53-88, scaled by max(L, M), coefficients scaled by L) and
the same delay-free output alignment (filter_delay skipped, y[k] ~ x(k*M/L)).
Instead of per-sample subfilter schedules with hand-unrolled SIMD
(resampler.cpp:267-454), each group of L output samples becomes one row-block
of a single [n_frames, W] x [W, L] matmul: frames are strided input windows,
G embeds all L polyphase subfilters at their window offsets. Streaming
carries a history of W-M input samples across chunks (overlap-save,
reference resampler.cpp:234-242,312-431).
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .filters import kaiser_lpf

# filter specs per oversampling factor (reference resampler_param.hpp:53-88)
F_PASS_NORM = {1: 0.48, 2: 0.30, 4: 0.20, 8: 0.15}
F_STOP_NORM = 0.499
F_STOP_ATT_DB = {1: 14.0, 2: 20.0, 4: 20.0, 8: 20.0}

# verified (hw_samp_rate, L, M) table (reference phy_config.cpp:32-67);
# dect_rate * L / M == hw_samp_rate * os_implied
VERIFIED_HW_RATES: tuple[tuple[int, int, int], ...] = (
    # native DECT rates, no resampling
    *(((r, 1, 1)) for r in (1728000, 3456000, 6912000, 13824000, 20736000,
                            27648000, 41472000, 55296000, 82944000,
                            110592000, 165888000, 221184000,
                            331776000, 442368000)),
    # LTE 30.72 MHz family
    (1920000, 10, 9), (3840000, 10, 9), (7680000, 10, 9), (15360000, 10, 9),
    (30720000, 40, 27), (30720000, 10, 9), (61440000, 40, 27),
    (61440000, 10, 9), (122880000, 40, 27), (122880000, 10, 9),
    (245760000, 40, 27), (245760000, 10, 9),
    (491520000, 40, 27), (491520000, 10, 9),
)


def get_resampler_fraction(dect_rate: int, hw_rate: int) -> tuple[int, int]:
    """L/M with hw_rate = dect_rate * L / M (TX direction), reduced."""
    f = Fraction(hw_rate, dect_rate)
    L, M = f.numerator, f.denominator
    if (L, M) not in {(1, 1), (10, 9), (40, 27), (20, 9), (80, 27), (2, 1)}:
        raise ValueError(f"unsupported resampling ratio {L}/{M} "
                         f"({dect_rate} -> {hw_rate})")
    return L, M


@dataclass(frozen=True)
class ResamplerPlan:
    L: int
    M: int
    os: int = 1

    @property
    def identity(self) -> bool:
        return self.L == self.M == 1


@lru_cache(maxsize=None)
def _design(plan: ResamplerPlan):
    """Returns (G [L, W], first_frame_m0): G row l holds subfilter phase(l)
    at its input-window offset; y[gL+l] = sum_w G[l,w] * x[gM + m0 + w]."""
    L, M = plan.L, plan.M
    big = max(L, M)
    h = kaiser_lpf(F_PASS_NORM[plan.os] / big, F_STOP_NORM / big,
                   stopband_att_db=F_STOP_ATT_DB[plan.os]) * L
    fd = (h.size - 1) // 2
    n_sub = -(-h.size // L)
    h = np.pad(h, (0, n_sub * L - h.size))
    # y[k] = sum_t h[p_k + t*L] * x[m_max_k - t],  m_max_k = (k*M + fd) // L
    m0 = (0 * M + fd) // L - (n_sub - 1)          # leftmost input tap of y[0]
    m_hi = ((L - 1) * M + fd) // L                # rightmost input tap of y[L-1]
    W = m_hi - m0 + 1
    G = np.zeros((L, W), dtype=np.float32)
    for l in range(L):
        p = (l * M + fd) % L
        mm = (l * M + fd) // L
        for t in range(n_sub):
            G[l, mm - t - m0] = h[p + t * L]
    return G, m0, W


def _out_len(n_in: int, L: int, M: int) -> int:
    return -(-n_in * L // M)


@lru_cache(maxsize=None)
def _sf_design(plan: ResamplerPlan):
    from .ops.polyphase import make_superframe_design
    G, m0, W = _design(plan)
    return make_superframe_design(G, plan.M)


#: "auto" resampler implementation per backend platform: on the GPU the
#: super-frame matmul ("xla_sf") measured faster than the strided-window
#: einsum ("gather") at the wall-cell and the streaming shapes (PERF.md,
#: bring-up findings); elsewhere (the CPU test mesh) "gather".
AUTO_IMPL = {"gpu": "xla_sf"}


def _resolve_impl(impl: str) -> str:
    if impl == "auto":
        return AUTO_IMPL.get(jax.default_backend(), "gather")
    if impl not in ("gather", "xla_sf"):
        raise ValueError(f"unknown resampler impl {impl!r}")
    return impl


@lru_cache(maxsize=None)
def build_resampler(plan: ResamplerPlan, n_in: int, impl: str = "auto"):
    """One-shot jitted resample(x [..., n_in]) -> [..., ceil(n_in*L/M)].

    Delay-free: y[k] lands at input time k*M/L (the filter group delay is
    absorbed, reference N_skip_input_samples_front). The tail is flushed
    with zeros (reference resample_final_samples).

    impl: "gather" (strided-window einsum), "xla_sf" (super-frame
    matmul, ops/polyphase.py), or "auto" (per platform, AUTO_IMPL).
    """
    L, M = plan.L, plan.M
    if plan.identity:
        return lambda x: x
    impl = _resolve_impl(impl)
    G, m0, W = _design(plan)
    n_out = _out_len(n_in, L, M)
    n_frames = -(-n_out // L)
    pad_l = max(0, -m0)
    need = (n_frames - 1) * M + m0 + W            # rightmost input index + 1
    pad_r = max(0, need - n_in)

    if impl == "xla_sf":
        from .ops.polyphase import (merge_complex_rows, polyphase_fir_xla,
                                    split_complex_rows)
        d, fir = _sf_design(plan), polyphase_fir_xla
        off = m0 + pad_l                          # >= 0: frame g starts g*M+off

        @jax.jit
        def resample_sf(x: jax.Array) -> jax.Array:
            shp = x.shape[:-1]
            xf = x.reshape(-1, n_in)
            xp = jnp.pad(xf, ((0, 0), (pad_l, pad_r)))[:, off:]
            y = merge_complex_rows(fir(split_complex_rows(xp), d, n_frames))
            return y.reshape(*shp, n_frames * L)[..., :n_out]

        return resample_sf

    fidx = (np.arange(n_frames)[:, None] * M + m0 + pad_l
            + np.arange(W)[None, :])              # [n_frames, W]
    Gt = G.T.astype(np.float32)                   # [W, L]

    @jax.jit
    def resample(x: jax.Array) -> jax.Array:
        shp = x.shape[:-1]
        xf = x.reshape(-1, n_in)
        xp = jnp.pad(xf, ((0, 0), (pad_l, pad_r)))
        frames = xp[:, fidx]                      # [B, n_frames, W]
        y = jnp.einsum("bfw,wl->bfl", frames, jnp.asarray(Gt))
        return y.reshape(*shp, n_frames * L)[..., :n_out]

    return resample


def stream_input_lag(plan: ResamplerPlan) -> int:
    """Input-sample lag D_in of the streaming resampler: chaining
    build_resampler_stream steps over x equals build_resampler applied to
    concat([zeros(D_in), x]). Output sample k therefore corresponds to input
    time k*M/L - D_in (the time-mapping constant for RX pacing)."""
    if plan.identity:
        return 0
    G, m0, W = _design(plan)
    return max(0, W + m0 - plan.M)


@lru_cache(maxsize=None)
def build_resampler_stream(plan: ResamplerPlan, chunk_in: int, impl: str = "auto"):
    """Streaming jitted step(x [..., chunk_in], hist [..., H]) -> (y, hist').

    chunk_in must be a multiple of M so the polyphase pattern tiles across
    chunks. Returns (step, H): hist starts as zeros [..., H] (overlap-save).
    Because a frame may need samples past the chunk end, the streamed output
    lags by D_in = H - pad_l input samples: chaining steps over chunks of x
    yields exactly build_resampler(...)(concat([zeros(D_in), x])) trimmed to
    the emitted length.
    """
    L, M = plan.L, plan.M
    if plan.identity:
        return (lambda x, hist: (x, hist)), 0
    assert chunk_in % M == 0, "chunk length must be a multiple of M"
    impl = _resolve_impl(impl)
    G, m0, W = _design(plan)
    pad_l = max(0, -m0)
    n_frames = chunk_in // M
    n_out = n_frames * L
    H = pad_l + max(0, (W + m0 - M))              # history carried across chunks

    if impl == "xla_sf":
        from .ops.polyphase import (merge_complex_rows, polyphase_fir_xla,
                                    split_complex_rows)
        d, fir = _sf_design(plan), polyphase_fir_xla
        off = m0 + pad_l

        @jax.jit
        def step_sf(x: jax.Array, hist: jax.Array):
            shp = x.shape[:-1]
            xf = x.reshape(-1, chunk_in)
            hf = hist.reshape(-1, H)
            xp = jnp.concatenate([hf, xf], axis=-1)
            y = merge_complex_rows(fir(split_complex_rows(xp[:, off:]), d,
                                       n_frames))
            return (y.reshape(*shp, n_out),
                    xp[:, chunk_in:].reshape(*shp, H))

        return step_sf, H

    # frame g of this chunk reads concat(hist, x)[g*M + m0 + pad_l + w]
    fidx = (np.arange(n_frames)[:, None] * M + m0 + pad_l
            + np.arange(W)[None, :])
    Gt = G.T.astype(np.float32)

    @jax.jit
    def step(x: jax.Array, hist: jax.Array):
        shp = x.shape[:-1]
        xf = x.reshape(-1, chunk_in)
        hf = hist.reshape(-1, H)
        xp = jnp.concatenate([hf, xf], axis=-1)
        frames = xp[:, fidx]
        y = jnp.einsum("bfw,wl->bfl", frames, jnp.asarray(Gt))
        new_hist = xp[:, chunk_in:]
        return (y.reshape(*shp, n_out),
                new_hist.reshape(*shp, H))

    return step, H
