"""XLA prefix-sum STF detection vs an independent numpy moving-sum reference.

_detect_xla (phy/sync.py) replaces the reference's streamed O(1) moving sums
(autocorrelator_detection.cpp:236-243, movsum.hpp) with whole-chunk prefix
sums; the numpy oracle below recomputes every window sum directly in
float64.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef


def _metric_reference(x, u, b):
    """Detection metric from explicit per-position window sums (float64)."""
    from dectnrp_tpu.sections.part3.stf import cover_sequence, n_stf_patterns

    P = 16 * b
    n_pat = n_stf_patterns(u)
    L = n_pat * P
    B, R, T = x.shape
    n_t = T - L - P
    cov = cover_sequence(u)
    w = (cov[:-1] * cov[1:]).astype(np.float64)
    norm = n_pat / (n_pat - 1)
    p = x[..., :T - P] * np.conj(x[..., P:])
    pw = np.abs(x) ** 2
    win = np.ones(P)
    # moving sums of length P / L by convolution, one start per position
    mp = np.apply_along_axis(lambda r: np.convolve(r, win, "valid"), -1, p)
    mw = np.apply_along_axis(lambda r: np.convolve(r, np.ones(L), "valid"),
                             -1, pw)
    C = sum(w[j] * mp[..., j * P:j * P + n_t] for j in range(n_pat - 1))
    P2 = mw[..., :n_t]
    Cs, P2s = C.sum(1), P2.sum(1)
    return norm * np.abs(Cs) / np.maximum(P2s, 1e-20)


def _smooth_reference(g, sl, sr):
    """Zero-padded moving average over [t - sl, t + sr]."""
    k = sl + sr + 1
    gp = np.pad(np.asarray(g, np.float64), ((0, 0), (sl, sr)))
    return np.apply_along_axis(lambda r: np.convolve(r, np.ones(k), "valid"),
                               -1, gp) / k


@pytest.mark.parametrize("u,b", [(1, 8), (8, 16)])
def test_detect_xla_matches_moving_sums(u, b):
    from dectnrp_tpu.phy.sync import SyncParams, _detect_xla
    from dectnrp_tpu.sections.part3.stf import cover_sequence, n_stf_patterns

    P = 16 * b
    n_pat = n_stf_patterns(u)
    T = 40 * P + 7
    B, R = 2, 2
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, R, T))
         + 1j * rng.standard_normal((B, R, T))).astype(np.complex64)
    # a strongly periodic cover-weighted segment so the gate opens
    seg = np.tile(x[0, :, :P], (1, 12))[:, :12 * P]
    x[0, :, 5 * P:17 * P] = seg * np.repeat(
        np.resize(cover_sequence(u), 12), P)[None, :]

    pr = SyncParams()
    sl, sr = pr.smooth_left * b, pr.smooth_right * b
    cov = cover_sequence(u)
    w = (cov[:-1] * cov[1:]).astype(np.float32)
    n_t = T - n_pat * P - P
    sm, metric, metric_g, _, _ = (np.asarray(v) for v in _detect_xla(
        jnp.asarray(x), P, w, n_t, n_pat / (n_pat - 1), sl, sr, pr))
    metric_ref = _metric_reference(x.astype(np.complex128), u, b)
    np.testing.assert_allclose(metric, metric_ref, rtol=2e-3, atol=2e-4)
    # gate and smoothing on the metric itself (a float32 metric within
    # rounding of the threshold may fall on either side of it)
    gate = (metric > pr.metric_threshold) & (metric < pr.metric_max)
    np.testing.assert_array_equal(metric_g, np.where(gate, metric, 0.0))
    assert gate[0].any() and not gate[1].any()       # the gate did open
    np.testing.assert_allclose(sm, _smooth_reference(metric_g, sl, sr),
                               rtol=2e-3, atol=2e-4)


def test_multi_peak_ordering():
    """Three packets of decreasing SNR in one chunk: all found, reported in
    descending smoothed-metric order, each at its sample position."""
    import jax

    from dectnrp_tpu.phy.sync import SyncParams, _detect_xla, build_sync
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu.sections.part3.packet_sizes import get_packet_sizes
    from dectnrp_tpu.sections.part3.stf import cover_sequence, n_stf_patterns

    u, b = 1, 8
    psdef = PacketSizesDef(u, b, 0, 1, 0, 1, 6144)
    ps = get_packet_sizes(psdef)
    rng = np.random.default_rng(4)
    tx = build_tx(psdef, 0x12345678, 1)
    plcf = jnp.asarray(rng.integers(0, 2, (3, 40)), jnp.uint8)
    tb = jnp.asarray(rng.integers(0, 2, (3, ps.N_TB_bits)), jnp.uint8)
    fl = jnp.zeros((3,), bool)
    iq = np.asarray(tx(plcf, tb, fl, fl))[:, 0]         # [3, n_pkt]
    T = 1 << 14
    offs = [9000, 800, 4400]
    amps = [1.0, 0.5, 0.3]                              # SNR 20 / 14 / 9.5 dB
    nv = 10 ** (-20 / 10)
    x = (rng.standard_normal((1, 1, T)) + 1j * rng.standard_normal(
        (1, 1, T))) * np.sqrt(nv / 2)
    n = iq.shape[-1]
    for k in range(3):
        x[0, 0, offs[k]:offs[k] + n] += amps[k] * iq[k]
    x = jnp.asarray(x.astype(np.complex64))

    rep = jax.tree_util.tree_map(np.asarray, build_sync(u, b, T, max_peaks=3)(x))
    assert rep["detected"].all()
    np.testing.assert_array_less(np.abs(rep["t_fine"][0] - np.asarray(offs)), 3)

    pr = SyncParams()
    P, n_pat = 16 * b, n_stf_patterns(u)
    cov = cover_sequence(u)
    sm = np.asarray(_detect_xla(x, P, (cov[:-1] * cov[1:]).astype(np.float32),
                                T - n_pat * P - P, n_pat / (n_pat - 1),
                                pr.smooth_left * b, pr.smooth_right * b,
                                pr)[0])[0]
    peaks = sm[rep["t_coarse"][0]]
    assert np.all(np.diff(peaks) <= 0), peaks
