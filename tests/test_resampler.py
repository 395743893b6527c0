"""Polyphase resampler: rate table, tone EVM, round trip, streaming parity.

Oracles: reference resampler specs (resampler_param.hpp f_pass/att table,
~25 dB EVM floor README.md:313-317) and the verified rate table
(phy_config.cpp:32-67).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from dectnrp_tpu.phy.resampler import (
    ResamplerPlan, build_resampler, build_resampler_stream,
    get_resampler_fraction, _out_len)


def _evm_db(ref, est):
    err = np.linalg.norm(est - ref)
    return -20 * np.log10(err / np.linalg.norm(ref))


def _tone(n, f, fs=1.0):
    t = np.arange(n) / fs
    return np.exp(2j * np.pi * f * t).astype(np.complex64)


@pytest.mark.parametrize("dect,hw,LM", [
    (1728000, 1920000, (10, 9)),
    (13824000, 15360000, (10, 9)),
    (20736000, 30720000, (40, 27)),
    (27648000, 30720000, (10, 9)),
    (221184000, 245760000, (10, 9)),
    (165888000, 245760000, (40, 27)),
    (1728000, 1728000, (1, 1)),
])
def test_rate_table(dect, hw, LM):
    assert get_resampler_fraction(dect, hw) == LM


def test_tone_preserved_10_9():
    plan = ResamplerPlan(10, 9)
    n = 9 * 200
    f = 0.10                              # well inside f_pass 0.48/10
    x = _tone(n, f)
    y = np.asarray(build_resampler(plan, n)(jnp.asarray(x)))
    n_out = _out_len(n, 10, 9)
    assert y.size == n_out
    # output sample k sits at input time k*9/10 -> same absolute tone
    ref = np.exp(2j * np.pi * f * np.arange(n_out) * 9 / 10)
    m = slice(50, n_out - 50)             # ignore edge transients
    evm = _evm_db(ref[m], y[m])
    assert evm > 25.0, evm


def test_tone_preserved_down_9_10():
    plan = ResamplerPlan(9, 10)
    n = 10 * 200
    x = _tone(n, 0.08)
    y = np.asarray(build_resampler(plan, n)(jnp.asarray(x)))
    n_out = _out_len(n, 9, 10)
    ref = np.exp(2j * np.pi * 0.08 * np.arange(n_out) * 10 / 9)
    evm = _evm_db(ref[50:-50], y[50:-50])
    assert evm > 25.0, evm


def test_round_trip_tx_rx():
    """TX 10/9 up then RX 9/10 down returns the band-limited input (EVM floor)."""
    rng = np.random.default_rng(0)
    n = 9 * 10 * 30
    # band-limited noise: OFDM-like spectrum within +-0.453/2... use tones
    x = sum(_tone(n, f) for f in (0.05, -0.12, 0.21)).astype(np.complex64)
    up = build_resampler(ResamplerPlan(10, 9), n)
    n_up = _out_len(n, 10, 9)
    down = build_resampler(ResamplerPlan(9, 10), n_up)
    y = np.asarray(down(up(jnp.asarray(x))))
    n_back = _out_len(n_up, 9, 10)
    assert abs(n_back - n) <= 1
    m = slice(100, min(n, n_back) - 100)
    evm = _evm_db(x[m], y[:min(n, n_back)][m])
    assert evm > 23.0, evm


def test_streaming_matches_oneshot_delayed():
    plan = ResamplerPlan(10, 9)
    chunk = 9 * 16
    n_chunks = 6
    n = chunk * n_chunks
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    step, H = build_resampler_stream(plan, chunk)
    hist = jnp.zeros((H,), jnp.complex64)
    outs = []
    for c in range(n_chunks):
        y, hist = step(jnp.asarray(x[c * chunk:(c + 1) * chunk]), hist)
        outs.append(np.asarray(y))
    y_stream = np.concatenate(outs)
    D_in = H - max(0, -(_design_m0(plan)))
    x_del = np.concatenate([np.zeros(D_in, np.complex64), x])
    y_ref = np.asarray(build_resampler(plan, x_del.size)(jnp.asarray(x_del)))
    np.testing.assert_allclose(y_stream, y_ref[:y_stream.size], rtol=0, atol=1e-4)


def _design_m0(plan):
    from dectnrp_tpu.phy.resampler import _design
    return _design(plan)[1]


def test_40_27_tone():
    plan = ResamplerPlan(40, 27)
    n = 27 * 80
    x = _tone(n, 0.15)
    y = np.asarray(build_resampler(plan, n)(jnp.asarray(x)))
    n_out = _out_len(n, 40, 27)
    ref = np.exp(2j * np.pi * 0.15 * np.arange(n_out) * 27 / 40)
    evm = _evm_db(ref[100:-100], y[100:-100])
    assert evm > 25.0, evm


@pytest.mark.parametrize("platform,impl", [("cpu", "gather"),
                                           ("gpu", "xla_sf")])
def test_resampler_auto_resolves_per_platform(monkeypatch, platform, impl):
    """"auto" picks the faster implementation of the backend platform."""
    import jax

    from dectnrp_tpu.phy import resampler

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert resampler._resolve_impl("auto") == impl
    assert resampler._resolve_impl("gather") == "gather"
    with pytest.raises(ValueError):
        resampler._resolve_impl("pallas")
