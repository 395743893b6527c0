"""Super-frame polyphase FIR vs the gather-einsum reference path.

The super-frame matmul (dectnrp_tpu/phy/ops/polyphase.py) must reproduce the
validated strided-window einsum (phy/resampler.py) bit-for-bit up to float
summation order, for both one-shot and streaming resampling, at every
supported L/M ratio.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from dectnrp_tpu.phy.ops.polyphase import (make_superframe_design,
                                           merge_complex_rows,
                                           split_complex_rows)
from dectnrp_tpu.phy.resampler import (ResamplerPlan, _design,
                                       build_resampler,
                                       build_resampler_stream)

RATIOS = [(10, 9), (9, 10), (40, 27), (27, 40)]


def _iq(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        .astype(np.complex64)


@pytest.mark.parametrize("L,M", RATIOS)
def test_superframe_design_embedding(L, M):
    plan = ResamplerPlan(L, M)
    G, m0, W = _design(plan)
    d = make_superframe_design(G, M)
    assert d.Wb <= 2 * d.in_per_sf  # one halo block suffices
    # column s*L+l of Gbig is G[l] placed at offset s*M
    for s in (0, d.S - 1):
        for l in (0, L - 1):
            col = d.Gbig[:, s * L + l]
            np.testing.assert_array_equal(col[s * M: s * M + W], G[l])
            assert np.count_nonzero(col) == np.count_nonzero(G[l])


@pytest.mark.parametrize("L,M", RATIOS)
def test_oneshot_impls_match(L, M):
    plan = ResamplerPlan(L, M)
    rng = np.random.default_rng(1)
    n_in = 4 * M * 37
    x = _iq(rng, (3, n_in))
    ref = np.asarray(build_resampler(plan, n_in, impl="gather")(jnp.asarray(x)))
    sf = np.asarray(build_resampler(plan, n_in, impl="xla_sf")(jnp.asarray(x)))
    np.testing.assert_allclose(sf, ref, rtol=2e-5, atol=2e-5)


def test_streaming_superframe_matches_gather():
    plan = ResamplerPlan(10, 9)
    chunk = 9 * 24
    step_g, H = build_resampler_stream(plan, chunk, impl="gather")
    step_s, H2 = build_resampler_stream(plan, chunk, impl="xla_sf")
    assert H == H2
    rng = np.random.default_rng(3)
    x = _iq(rng, (2, 4 * chunk))
    hg = hs = jnp.zeros((2, H), jnp.complex64)
    for c in range(4):
        xc = jnp.asarray(x[:, c * chunk:(c + 1) * chunk])
        yg, hg = step_g(xc, hg)
        ys, hs = step_s(xc, hs)
        np.testing.assert_allclose(np.asarray(ys), np.asarray(yg),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(np.asarray(hs), np.asarray(hg))


def test_complex_row_split_roundtrip():
    rng = np.random.default_rng(4)
    x = jnp.asarray(_iq(rng, (5, 33)))
    np.testing.assert_array_equal(
        np.asarray(merge_complex_rows(split_complex_rows(x))), np.asarray(x))
