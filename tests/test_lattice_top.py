"""Top of the config lattice: psdef fuzz + b=12/b=16 decode + 8x8 modes.

Reference oracles:
- tx_packet_random.cpp:40-139: random packets within a radio device class,
  internal-consistency asserts (the postconditions in tx.cpp:299-313).
- get_random_packet_sizes_within_rdc (packet_sizes.cpp:260-316).
- W[6] 8x8 codebook / tm modes 10 (8-TS TxDiv) and 11 (8x8 spatial mux).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dectnrp_tpu.phy.rx import build_rx
from dectnrp_tpu.phy.tx import build_tx
from dectnrp_tpu.sections.part3.packet_sizes import (PacketSizesDef,
                                                     get_packet_sizes)
from dectnrp_tpu.simulation.channels import awgn

NID = 0x12345678


def _random_valid_psdefs(rng, n, u_set=(1, 2, 4, 8), b_set=(1, 2, 4, 8, 12, 16),
                         tm_set=tuple(range(12)), mcs_max=9):
    """Rejection-sample n valid psdefs across the full lattice."""
    out = []
    tries = 0
    while len(out) < n and tries < 50 * n:
        tries += 1
        plt = int(rng.integers(0, 2))
        psdef = PacketSizesDef(
            int(rng.choice(u_set)), int(rng.choice(b_set)), plt,
            int(rng.integers(1, 17 if plt else 5)),
            int(rng.choice(tm_set)), int(rng.integers(0, mcs_max + 1)), 6144)
        if get_packet_sizes(psdef) is not None:
            out.append(psdef)
    assert len(out) == n, f"only {len(out)} valid psdefs found"
    return out


def test_psdef_fuzz_internal_consistency():
    """200 random valid psdefs: the derivation invariants the reference
    asserts in packet_sizes.cpp / tx.cpp postconditions."""
    rng = np.random.default_rng(0)
    for psdef in _random_valid_psdefs(rng, 200):
        ps = get_packet_sizes(psdef)
        q, tm = ps.numerology, ps.tm_mode
        assert ps.N_samples_packet == (ps.N_samples_STF + ps.N_samples_DF
                                       + ps.N_samples_GI), psdef
        assert ps.N_samples_DF == ps.N_DF_symb * ps.N_samples_OFDM_symbol
        assert ps.N_samples_OFDM_symbol == 72 * psdef.b
        # PDC cell count: everything in the DF not DRS or PCC (pdc.cpp:203)
        assert ps.N_PDC_subc == ps.N_DF_symb * q.N_b_OCC - ps.N_DRS_subc - 98, \
            psdef
        assert ps.G == ps.N_PDC_subc * ps.mcs.N_bps * tm.N_SS, psdef
        assert ps.N_TB_bits <= ps.N_PDC_bits <= ps.G
        if ps.N_TB_bits + 24 <= psdef.Z:
            assert ps.C == 1, psdef
        else:
            assert ps.C == -(-(ps.N_TB_bits + 24) // (psdef.Z - 24)), psdef
        assert ps.N_TB_byte * 8 == ps.N_TB_bits


def test_psdef_fuzz_tx_synthesis():
    """Random lattice points through the full TX jit: shape/energy sanity
    (tx_packet_random's role: the synthesis path holds together across the
    whole lattice, not just the benched corner)."""
    rng = np.random.default_rng(1)
    # bound jit compile cost: moderate sizes only
    defs = [p for p in _random_valid_psdefs(rng, 40)
            if get_packet_sizes(p).N_samples_packet <= 40000][:8]
    for psdef in defs:
        ps = get_packet_sizes(psdef)
        tx = build_tx(psdef, NID, 1)
        plcf = jnp.asarray(rng.integers(0, 2, (1, 40)), jnp.uint8)
        tb = jnp.asarray(rng.integers(0, 2, (1, ps.N_TB_bits)), jnp.uint8)
        fl = jnp.zeros((1,), bool)
        iq = np.asarray(tx(plcf, tb, fl, fl))
        assert iq.shape == (1, ps.tm_mode.N_TX, ps.N_samples_packet), psdef
        assert np.isfinite(iq).all(), psdef
        body = iq[..., :ps.N_samples_packet - ps.N_samples_GI]
        assert np.abs(body).max() > 0, psdef
        # GI is zeroed (tx.cpp zeroed GI postcondition)
        gi = iq[..., ps.N_samples_packet - ps.N_samples_GI:]
        assert np.abs(gi).max() < 1e-3 * np.abs(body).max() + 1e-12, psdef


@pytest.mark.parametrize("b,mcs,snr", [(12, 4, 20.0), (16, 4, 20.0)])
def test_wide_beta_loopback_decode(b, mcs, snr):
    """b=12 / b=16 full aligned loopback decode (the top of the beta
    axis)."""
    psdef = PacketSizesDef(1, b, 0, 4, 0, mcs, 6144)
    ps = get_packet_sizes(psdef)
    assert ps is not None
    tx = build_tx(psdef, NID, 1)
    rx = build_rx(psdef, NID, 1)
    rng = np.random.default_rng(2)
    B = 2
    plcf = jnp.asarray(rng.integers(0, 2, (B, 40)), jnp.uint8)
    tb = jnp.asarray(rng.integers(0, 2, (B, ps.N_TB_bits)), jnp.uint8)
    fl = jnp.zeros((B,), bool)
    iq = tx(plcf, tb, fl, fl)
    sig = float(np.mean(np.abs(np.asarray(iq)) ** 2))
    nv = jnp.float32(sig / 10 ** (snr / 10))
    out = rx(awgn(jax.random.PRNGKey(0), iq, nv), nv)
    assert bool(out["plcf1_ok"].all())
    assert bool(out["tb_ok"].all())
    assert np.array_equal(np.asarray(out["tb"]), np.asarray(tb))
