"""Polyphase fractional-resampler FIR as one super-frame matmul.

The reference resampler (lib/src/phy/resample/resampler.cpp:267-454) walks the
input sample-by-sample through hand-unrolled SIMD subfilter schedules.  The
basic formulation (phy/resampler.py "gather") turns each group of L outputs
into a row of a [n_frames, W] x [W, L] matmul, whose strided window gather
materializes a W/M ~ 3.4x blowup of the input in device memory.

This module packs S consecutive frames into one "super-frame" row:

    y[b, g*S*L + n] = sum_w  x[b, g*S*M + w] * Gbig[w, n]

with Gbig [S*M + E, S*L] the block-Toeplitz embedding of the L polyphase
subfilters (E = W - M extra overlap columns). `polyphase_fir_xla` builds the
windows by reshape + 2 static slices + concat (no gather HLO), then runs one
einsum.

Real filter taps on complex IQ: callers split complex64 into stacked
real/imag float32 rows (see `split_complex_rows` / `merge_complex_rows`).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


def _digest(a: np.ndarray) -> str:
    return hashlib.sha1(a.tobytes()).hexdigest()


@dataclass(frozen=True)
class SuperframeDesign:
    """Static geometry of the super-frame matmul for one (G, M) design.

    Hash/eq use the static fields plus a content digest of Gbig (the array
    itself is excluded so ad-hoc designs with identical taps share compiled
    kernels and jit caches).
    """
    S: int          # frames per super-frame
    M: int          # input samples per frame
    L: int          # output samples per frame
    W: int          # single-frame window width
    Wb: int         # super-frame window width = S*M + E
    gkey: str       # sha1 of Gbig bytes
    Gbig: np.ndarray = field(compare=False, repr=False)  # [Wb, S*L] float32

    @property
    def in_per_sf(self) -> int:
        return self.S * self.M

    @property
    def out_per_sf(self) -> int:
        return self.S * self.L


def make_superframe_design(G: np.ndarray, M: int, S: int | None = None) -> SuperframeDesign:
    """Embed the [L, W] polyphase bank G into a block-Toeplitz [Wb, S*L].

    G row l holds subfilter phase l at its window offset (resampler._design):
    y[g*L + l] = sum_w G[l, w] x[g*M + w].  Within a super-frame of S frames,
    frame s reads window [s*M, s*M + W), so Gbig[s*M + w, s*L + l] = G[l, w].
    """
    L, W = G.shape
    if S is None:
        S = max(1, int(round(128 / L)))
    # halo must fit in one extra super-frame block (kernel passes 1 halo)
    while W - M > S * M:
        S += 1
    Wb = S * M + (W - M)
    Gbig = np.zeros((Wb, S * L), dtype=np.float32)
    for s in range(S):
        Gbig[s * M: s * M + W, s * L: (s + 1) * L] = G.T
    return SuperframeDesign(S=S, M=M, L=L, W=W, Wb=Wb,
                            gkey=_digest(Gbig), Gbig=Gbig)


def split_complex_rows(x: jax.Array) -> jax.Array:
    """[B, T] complex64 -> [2B, T] float32 (real rows then imag rows)."""
    return jnp.concatenate([x.real, x.imag], axis=0).astype(jnp.float32)


def merge_complex_rows(y: jax.Array) -> jax.Array:
    """Inverse of split_complex_rows."""
    B2 = y.shape[0]
    return (y[: B2 // 2] + 1j * y[B2 // 2:]).astype(jnp.complex64)


def _pad_for_superframes(xp: jax.Array, in_per_sf: int, n_frames: int, S: int):
    """Pad [B2, n_pad] so every super-frame window (incl. one halo) exists."""
    n_sf = -(-n_frames // S)
    need = n_sf * in_per_sf + in_per_sf  # + one full halo block
    pad = max(0, need - xp.shape[-1])
    if pad:
        xp = jnp.pad(xp, ((0, 0), (0, pad)))
    return xp, n_sf


def polyphase_fir_xla(xp: jax.Array, d: SuperframeDesign, n_frames: int) -> jax.Array:
    """Reference/portable path: [B2, n_pad] f32 -> [B2, n_frames*L] f32."""
    xp, n_sf = _pad_for_superframes(xp, d.in_per_sf, n_frames, d.S)
    B2 = xp.shape[0]
    sm = d.in_per_sf
    resh = xp[:, : (n_sf + 1) * sm].reshape(B2, n_sf + 1, sm)
    wide = jnp.concatenate([resh[:, :n_sf], resh[:, 1: n_sf + 1]], axis=-1)
    fr = wide[:, :, : d.Wb]                               # [B2, n_sf, Wb]
    y = jnp.einsum("bfw,wn->bfn", fr, jnp.asarray(d.Gbig))
    return y.reshape(B2, n_sf * d.out_per_sf)[:, : n_frames * d.L]
