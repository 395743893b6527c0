"""External absolute-SNR anchor: uncoded BER vs closed-form theory.

Without it the PER oracle would be validated only against itself.  This test
anchors the simulation's SNR calibration (noise_var convention, demapper
scaling) against textbook AWGN BER:

  QPSK (Gray):    BER = Q(sqrt(Es/N0))
  16-QAM (Gray):  BER ~ (3/4) Q(sqrt(Es/N0 / 5))  (nearest-neighbour approx)

with Es/N0 = 1/noise_var for unit-energy constellations.  If these hold, the
absolute placement of every PER-vs-SNR waterfall in results/ is calibrated
(the reference cross-checks vs MATLAB + commercial devices, README.md:329).
"""
import numpy as np
import pytest


def qfunc(x):
    from math import erfc, sqrt
    return 0.5 * erfc(x / sqrt(2.0))


@pytest.mark.parametrize("n_bps,snr_db", [(2, 4.0), (2, 8.0), (2, 10.0),
                                          (4, 12.0), (4, 16.0), (4, 18.0)])
def test_uncoded_ber_matches_theory(n_bps, snr_db):
    import jax
    import jax.numpy as jnp

    from dectnrp_tpu.phy.modulation import demap_llr, map_bits

    n_bits = 1_200_000 // 1
    n_bits -= n_bits % n_bps
    rng = np.random.default_rng(42 + n_bps * 100 + int(snr_db))
    bits = rng.integers(0, 2, (1, n_bits)).astype(np.uint8)
    nv = 10.0 ** (-snr_db / 10.0)

    @jax.jit
    def run(b, key):
        sym = map_bits(b, n_bps)
        k1, k2 = jax.random.split(key)
        n = (jax.random.normal(k1, sym.shape)
             + 1j * jax.random.normal(k2, sym.shape))
        y = sym + jnp.sqrt(nv / 2.0) * n.astype(jnp.complex64)
        llr = demap_llr(y, jnp.ones_like(sym.real), n_bps, nv)
        return jnp.sum((llr > 0).astype(jnp.uint8) != b)

    errs = int(run(jnp.asarray(bits), jax.random.PRNGKey(0)))
    ber = errs / n_bits
    es_n0 = 1.0 / nv
    if n_bps == 2:
        ber_theory = qfunc(np.sqrt(es_n0))
    else:
        ber_theory = 0.75 * qfunc(np.sqrt(es_n0 / 5.0))
    # 15% relative + tiny absolute floor for the MC noise at high SNR
    assert abs(ber - ber_theory) <= 0.15 * ber_theory + 2e-5, \
        (n_bps, snr_db, ber, ber_theory)


def _constellation(n_bps: int) -> np.ndarray:
    """All 2**n_bps unit-average-energy constellation points (map_bits)."""
    import itertools

    from dectnrp_tpu.phy.modulation import map_bits
    bits = np.array(list(itertools.product((0, 1), repeat=n_bps)), np.uint8)
    return np.asarray(map_bits(bits.reshape(-1), n_bps)).reshape(-1)


def _mi_dispersion(const: np.ndarray, snr_lin: float, rng, n_mc=200_000):
    """Monte-Carlo mutual information C (bits/use) and dispersion V of the
    discrete-input complex AWGN channel at Es/N0 = snr_lin."""
    sigma2 = 1.0 / snr_lin
    x = const[rng.integers(0, const.size, n_mc)]
    y = x + np.sqrt(sigma2 / 2) * (rng.standard_normal(n_mc)
                                   + 1j * rng.standard_normal(n_mc))
    # info density: log2( p(y|x) / mean_j p(y|x_j) ), constants cancel
    lp = -np.abs(y[:, None] - const[None, :]) ** 2 / sigma2      # [n, M]
    lpx = -np.abs(y - x) ** 2 / sigma2
    m = lp.max(axis=1, keepdims=True)
    lse = (m[:, 0] + np.log(np.exp(lp - m).mean(axis=1)))
    info = (lpx - lse) / np.log(2.0)
    return float(info.mean()), float(info.var())


def _na_per(n: int, k: int, const: np.ndarray, snr_db: float, rng) -> float:
    """Finite-blocklength normal approximation of the best achievable PER
    for k info bits over n uses of the discrete-input AWGN channel."""
    import math
    C, V = _mi_dispersion(const, 10 ** (snr_db / 10.0), rng)
    z = (n * C - k + 0.5 * math.log2(n)) / math.sqrt(max(n * V, 1e-9))
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def test_coded_waterfall_vs_finite_blocklength():
    """EXTERNAL anchor for the coded operating points: each MCS's committed
    aligned-AWGN PER=0.1 threshold must sit within [NA - 0.5 dB, NA + 3 dB]
    of the finite-blocklength normal approximation (Polyanskiy et al.) for
    (n = N_PDC_subc uses, k = N_TB_bits + 24) over the ACTUAL constellation.
    The lower edge catches impossible curves (noise miscalibration); the
    upper edge bounds the turbo + estimation implementation loss. This
    anchors the waterfall POSITIONS to information theory instead of the
    repo's own previous sweep."""
    import json
    import os

    from dectnrp_tpu.sections.part3.packet_sizes import (PacketSizesDef,
                                                         get_packet_sizes)

    root = os.path.join(os.path.dirname(__file__), "..", "results",
                        "loopback_snr", "aligned")
    rng = np.random.default_rng(0)
    checked = 0
    losses = []
    for mcs in (1, 2, 3, 4):
        p = os.path.join(root, f"rx_loopback_MCS_{mcs:04d}.json")
        if not os.path.exists(p):
            pytest.skip("sweep artifacts not present")
        d = json.load(open(p))
        snrs = d["experiment_range"]["snr_vec"]
        th = None
        for s, x in zip(snrs, d["result"]["PER_pdc_crc"]):
            if x <= 0.1:
                th = s
                break
        assert th is not None, f"MCS {mcs}: no waterfall"
        psdef = PacketSizesDef(1, 1, 0, 2, 0, mcs, 6144)
        ps = get_packet_sizes(psdef)
        const = _constellation(ps.mcs.N_bps)
        n, k = ps.N_PDC_subc, ps.N_TB_bits + 24
        # bisect the NA threshold (PER = 0.1)
        lo, hi = -5.0, 25.0
        for _ in range(24):
            mid = 0.5 * (lo + hi)
            if _na_per(n, k, const, mid, rng) > 0.1:
                lo = mid
            else:
                hi = mid
        na = 0.5 * (lo + hi)
        assert na - 0.5 <= th <= na + 3.0, \
            f"MCS {mcs}: threshold {th} dB vs NA {na:.2f} dB"
        losses.append(th - na)
        checked += 1
    assert checked == 4
    # tracked implementation loss: r05 measured 2.30-2.56 dB per MCS
    # (turbo max-log + 6-iter early stop + estimation overhead on a 1 dB
    # sweep grid). The mean bound fails if the loss silently grows ~0.3 dB
    # — the per-MCS +3 dB edge alone leaves that drift invisible.
    mean_loss = sum(losses) / len(losses)
    assert mean_loss <= 2.75, f"mean implementation loss {mean_loss:.2f} dB"
