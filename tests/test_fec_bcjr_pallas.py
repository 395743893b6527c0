"""GPU BCJR kernel (Pallas interpreter) vs the XLA windowed max-log-MAP oracle."""
from functools import partial

import numpy as np
import pytest


def _rand_llrs(K, B, seed=0):
    import jax.numpy as jnp

    from dectnrp_tpu.phy.fec.turbo_jax import turbo_encode

    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.asarray(turbo_encode(jnp.asarray(c), K)).astype(np.float32)
    llr = (2.0 * d - 1.0) * 4.0 + rng.standard_normal(d.shape).astype(np.float32)
    return c, jnp.asarray(llr)


def _random_streams(K, B, seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    Ls = jnp.asarray(rng.standard_normal((B, K + 3)).astype(np.float32) * 3)
    Lp = jnp.asarray(rng.standard_normal((B, K + 3)).astype(np.float32) * 3)
    La = jnp.asarray(rng.standard_normal((B, K)).astype(np.float32))
    return Ls, Lp, La


@pytest.mark.parametrize("K,B", [(512, 3), (1056, 2), (2048, 1)])
def test_bcjr_pallas_matches_windowed(K, B):
    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_gpu
    from dectnrp_tpu.phy.fec.turbo_jax import _bcjr_posterior_windowed

    Ls, Lp, La = _random_streams(K, B, K)
    ref = np.asarray(_bcjr_posterior_windowed(Ls, Lp, La, K, Lw=128, D=32))
    got = np.asarray(bcjr_posterior_gpu(Ls, Lp, La, K, Lw=128, D=32,
                                        interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("K,B", [
    (6144, 2),          # largest K; K+3 leaves a 3-step last window
    (1056, 130),        # two column tiles, the second padded
    (6144, 131),        # both at once
])
def test_bcjr_kernel_matches_windowed_columns(K, B):
    """Column-major kernel, column count not a multiple of the tile, last
    window partial: identical posteriors to the reference."""
    import jax.numpy as jnp

    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_gpu_cm
    from dectnrp_tpu.phy.fec.turbo_jax import _bcjr_posterior_windowed

    Ls, Lp, La = _random_streams(K, B, K + B)
    ref = np.asarray(_bcjr_posterior_windowed(Ls, Lp, La, K, Lw=128, D=32))
    Lsys = Ls + jnp.pad(La, ((0, 0), (0, 3)))
    got = np.asarray(bcjr_posterior_gpu_cm(Lsys.T, Lp.T, K,
                                           interpret=True)).T
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_turbo_decode_pallas_impl_roundtrip():
    """Full turbo iterations through the kernel (column-major decode state)
    decode cleanly and agree bit for bit with the XLA engine."""
    import jax
    import jax.numpy as jnp

    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_gpu_cm
    from dectnrp_tpu.phy.fec.turbo_jax import _make_iter, turbo_decode

    K, B = 1056, 2
    c, llr = _rand_llrs(K, B, seed=5)
    kern = partial(bcjr_posterior_gpu_cm, K=K, Lw=128, D=32, interpret=True)

    @jax.jit
    def decode(d_llr):
        one_iter, La1 = _make_iter(d_llr, K, "cm", kern)
        La1, post = jax.lax.scan(lambda a, _: one_iter(a), La1, None,
                                 length=4)
        return (post[-1].T > 0).astype(jnp.uint8)

    bits = np.asarray(decode(llr))
    np.testing.assert_array_equal(bits, c)
    bits_x, _ = turbo_decode(llr, K, n_iter=4, impl="xla")
    np.testing.assert_array_equal(np.asarray(bits_x), c)


@pytest.mark.parametrize("platform,K,kind", [
    ("gpu", 6144, "cm"), ("cpu", 6144, "rm"), ("gpu", 256, "rm")])
def test_resolve_bcjr_auto_per_platform(monkeypatch, platform, K, kind):
    """"auto" takes the compiled kernel on a GPU for windowed decode and
    the XLA engine otherwise; the kernel is never interpreted there."""
    import jax

    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_gpu_cm
    from dectnrp_tpu.phy.fec.turbo_jax import _resolve_bcjr

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    got_kind, fn = _resolve_bcjr(K, None, "auto")
    assert got_kind == kind
    if kind == "cm":
        assert fn.func is bcjr_posterior_gpu_cm
        assert fn.keywords["interpret"] is False
    else:
        assert getattr(fn, "func", fn) is not bcjr_posterior_gpu_cm


def test_resolve_bcjr_rejects_unknown_and_short():
    from dectnrp_tpu.phy.fec.turbo_jax import _resolve_bcjr

    with pytest.raises(ValueError):
        _resolve_bcjr(6144, None, "pallas")
    with pytest.raises(ValueError):
        _resolve_bcjr(256, None, "gpu")         # unwindowed: no kernel


def test_bcjr_kernel_lowers_to_triton():
    """The kernel lowers for CUDA as a Triton call (no card needed)."""
    import jax
    import jax.numpy as jnp

    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_gpu_cm

    K, B = 1056, 200
    x = jax.ShapeDtypeStruct((K + 3, B), jnp.float32)
    low = jax.jit(lambda a, b: bcjr_posterior_gpu_cm(a, b, K)).trace(
        x, x).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in low.as_text()
