"""Sliding-window max-log-MAP BCJR as a Pallas kernel for NVIDIA Hopper.

The XLA formulation (turbo_jax._bcjr_posterior_windowed) runs each
recursion as a `lax.scan` of Lw+D dependent steps, every step a separate
small kernel over [B, W, 8], and materializes the branch metrics
gamma [B, K+3, 8, 2] plus per-window gathers of them in device memory.
This kernel (Pallas through Triton) runs one program per (window w, tile
of CT codeblock columns):

  * LLR streams are column-major [K+3, B], so one step's row load is
    coalesced across the tile's codeblocks;
  * the 8 trellis states are 8 [CT] register vectors; the trellis tables
    are unrolled in Python, so each step is a handful of vector max/adds;
  * gammas are recomputed per step from the two LLR rows (four distinct
    values 0.5*(+-Lsys +- Lp)), never stored;
  * the step loops are not unrolled: unrolling 8 steps cut the kernel time
    by ~10 % but raised its Triton compile time from ~1 s to ~22 s, paid
    again for every new (K, B) shape (PERF.md, bring-up findings);
  * the alpha history (Lw x 8 x CT f32, 512 KB at CT=128) does not fit a
    block's shared memory, and Triton exposes no scratch, so it spills to
    a second output that only this program writes and reads back;
  * the beta recursion runs backward over the same window and fuses the
    posterior max-reduction, writing only the [Lw, CT] posterior block.

Programs carry no state between each other: window and tile order is free.
Arithmetic follows the XLA reference step for step (same gamma signs, same
per-step max normalization, same (alpha + gamma) + beta posterior order).

Reference behavior: lib/src/phy/fec/pdc_enc.cpp:291-430 (srsRAN max-log-MAP
turbo decode); window acquisition mirrors turbo_jax._bcjr_posterior_windowed,
the correctness oracle (tests/test_fec_bcjr_pallas.py asserts equivalence).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

_NEG = -1e30
# codeblock columns per program (a power of two for Triton) and warps per
# program: CT 32..512 x 1..8 warps all ran within 15 % of each other on the
# card, measured on an 8-step-unrolled variant (PERF.md, bring-up findings)
CT = 128
NUM_WARPS = 4


def _tables():
    # local import to avoid a cycle (turbo_jax imports this module lazily)
    from .turbo_jax import NEXT, OUT_Z, PRED_C, PRED_S
    pred = tuple((int(PRED_S[s, e]), int(PRED_C[s, e]),
                  int(OUT_Z[PRED_S[s, e], PRED_C[s, e]]))
                 for s in range(8) for e in range(2))
    succ = tuple((int(NEXT[s, c]), int(OUT_Z[s, c]))
                 for s in range(8) for c in range(2))
    return pred, succ


def _gamma(ls, lp):
    """Branch metrics indexed [input bit c][parity z]: 0.5*(+-ls +- lp)."""
    pp = 0.5 * (ls + lp)
    pm = 0.5 * (ls - lp)
    return ((-pp, -pm), (pm, pp))


def _vmax(xs):
    m = xs[0]
    for x in xs[1:]:
        m = jnp.maximum(m, x)
    return m


@lru_cache(maxsize=None)
def _bcjr_call(Kt: int, B: int, Lw: int, D: int, interpret: bool):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    K = Kt - 3
    W = -(-Kt // Lw)
    NJ = -(-B // CT)
    pred, succ = _tables()

    def kernel(ls_ref, lp_ref, post_ref, hist_ref):
        w = pl.program_id(0)
        c0 = pl.program_id(1) * CT
        cols = pl.ds(c0, CT)
        cmask = c0 + jnp.arange(CT) < B
        zero = jnp.zeros((CT,), jnp.float32)
        neg = jnp.full((CT,), _NEG, jnp.float32)

        def rows(pos):
            r = jnp.clip(pos, 0, Kt - 1)
            ls = plgpu.load(ls_ref.at[r, cols], mask=cmask, other=0.0)
            lp = plgpu.load(lp_ref.at[r, cols], mask=cmask, other=0.0)
            return ls, lp

        def alpha_step(a, g, valid):
            def edge(e):                   # a[pred] + gamma[c][z] of edge e
                p, c, z = pred[e]
                return a[p] + g[c][z]
            new = [jnp.maximum(edge(2 * s), edge(2 * s + 1)) for s in range(8)]
            m = _vmax(new)
            return tuple(jnp.where(valid, x - m, y) for x, y in zip(new, a))

        def beta_step(b, g, valid):
            new = [jnp.maximum(b[succ[2 * s][0]] + g[0][succ[2 * s][1]],
                               b[succ[2 * s + 1][0]] + g[1][succ[2 * s + 1][1]])
                   for s in range(8)]
            m = _vmax(new)
            return tuple(jnp.where(valid, x - m, y) for x, y in zip(new, b))

        def alpha_body(store):
            def body(t, a):
                pos = w * Lw - D + t
                if store:                  # alpha_pos, before its update
                    for s in range(8):
                        hist_ref[(t - D) * 8 + s, :] = a[s]
                valid = (pos >= 0) & (pos < Kt)
                return alpha_step(a, _gamma(*rows(pos)), valid)
            return body

        def beta_body(emit):
            def body(t, b):
                pos = (w + 1) * Lw + D - 1 - t
                g = _gamma(*rows(pos))
                if emit:                   # posterior at pos from beta_pos+1
                    a = [hist_ref[(Lw + D - 1 - t) * 8 + s, :]
                         for s in range(8)]
                    hi = _vmax([a[s] + g[1][succ[2 * s + 1][1]]
                                + b[succ[2 * s + 1][0]] for s in range(8)])
                    lo = _vmax([a[s] + g[0][succ[2 * s][1]]
                                + b[succ[2 * s][0]] for s in range(8)])
                    plgpu.store(post_ref.at[pos, cols], hi - lo,
                                mask=cmask & (pos < K))
                valid = (pos >= 0) & (pos < Kt)
                return beta_step(b, g, valid)
            return body

        # window 0 starts in state 0, the others uniform (acquisition)
        a = (zero,) + tuple(jnp.where(w == 0, neg, zero) for _ in range(7))
        a = jax.lax.fori_loop(0, D, alpha_body(False), a)
        jax.lax.fori_loop(D, D + Lw, alpha_body(True), a)

        ends = (w + 1) * Lw + D >= Kt
        b = (zero,) + tuple(jnp.where(ends, neg, zero) for _ in range(7))
        b = jax.lax.fori_loop(0, D, beta_body(False), b)
        jax.lax.fori_loop(D, D + Lw, beta_body(True), b)

    return pl.pallas_call(
        kernel,
        grid=(W, NJ),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=(pl.BlockSpec(memory_space=pl.ANY),
                   pl.BlockSpec((Lw * 8, CT), lambda i, j: (i, j))),
        out_shape=(jax.ShapeDtypeStruct((K, B), jnp.float32),
                   jax.ShapeDtypeStruct((W * Lw * 8, NJ * CT), jnp.float32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bcjr_window",
    )


def bcjr_posterior_gpu_cm(Lsys, Lp, K: int, Lw: int = 128, D: int = 32,
                          interpret: bool = False):
    """Column-major windowed BCJR: Lsys, Lp [K+3, B] -> posterior [K, B].

    Lsys must already include the a-priori term (Ls + La) on the first K
    rows. `interpret` runs the kernel through the Pallas interpreter (CPU
    tests only).
    """
    Kt, B = Lsys.shape
    assert Kt == K + 3
    call = _bcjr_call(Kt, B, Lw, D, interpret)
    post, _ = call(Lsys.astype(jnp.float32), Lp.astype(jnp.float32))
    return post


def bcjr_posterior_gpu(Ls, Lp, La, K: int, Lw: int = 128, D: int = 32,
                       interpret: bool = False):
    """Row-major adapter: Ls/Lp [B, K+3], La [B, K] -> posterior [B, K]."""
    Lsys = (Ls + jnp.pad(La, ((0, 0), (0, 3)))).astype(jnp.float32)
    post = bcjr_posterior_gpu_cm(Lsys.T, Lp.astype(jnp.float32).T, K,
                                 Lw=Lw, D=D, interpret=interpret)
    return post.T.astype(Ls.dtype)
