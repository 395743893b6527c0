"""MIMO estimator: beamforming-codebook feedback from channel estimates.

Counterpart of reference lib/src/phy/rx/rx_synced/mimo/ (estimator_mimo.cpp
:80-250, mimo_report.hpp, mimo_csi.{hpp,cpp}): the wideband channel is
condensed to 4 cells (averaged subcarrier regions), then an exhaustive
search over the ETSI beamforming codebook W[N_TS -> N_TX] picks the index
maximizing the minimum per-cell received power (the reference's
min-RX-power metric for closed-loop single-stream modes 3/7); the
reciprocal variant transposes the channel for our own TX beamforming.

estimator_aoa_t is a stub in the reference (39 LoC, no implementation);
`estimate_aoa` here is a working Bartlett-spectrum implementation over the
antenna-array steering vectors — an intentional capability extension.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..sections.part3.beamforming import CODEBOOK_SIZES, get_all_W


@dataclass
class MimoReport:
    """Per-packet feedback (reference mimo_report.hpp)."""
    codebook_index: int = 0
    power_min_cell: float = 0.0        # metric of the winner
    N_TS: int = 1
    N_TX: int = 1


@dataclass
class MimoCsi:
    """Tracked per-contact CSI (reference mimo_csi.{hpp,cpp})."""
    codebook_index: int = 0
    last_update: int = -1
    history: list = field(default_factory=list)

    def update(self, report: MimoReport, now: int) -> None:
        self.codebook_index = report.codebook_index
        self.last_update = now
        self.history.append((now, report.codebook_index))
        if len(self.history) > 16:
            self.history = self.history[-8:]


def condense_wideband(h: np.ndarray, n_cells: int = 4) -> np.ndarray:
    """[..., n_subc] -> [..., n_cells]: average over contiguous regions
    (reference 'wideband 4-cell channel condensation')."""
    n = h.shape[-1] // n_cells * n_cells
    return h[..., :n].reshape(*h.shape[:-1], n_cells, -1).mean(-1)


@lru_cache(maxsize=None)
def _search_fn(N_TS: int, N_TX: int):
    import jax
    import jax.numpy as jnp

    # numpy here: jnp.asarray of a complex constant would be an EAGER device
    # transfer; inside the jit below it is baked into the program instead
    Wall = np.asarray(get_all_W(N_TS, N_TX))            # [n_cb, N_TX, N_TS]

    @jax.jit
    def search(h_cells):
        """h_cells [B, R, N_TX, 4] -> (best index [B], metric [B]).

        For every candidate W: received power per cell ||H_c W||_F^2,
        metric = min over the 4 cells, winner = argmax over the codebook.
        """
        # [B, R, c, rx=R?, ...] -> z[b, n_cb, cell, r, s]
        z = jnp.einsum("brtc,nts->bncrs", h_cells.transpose(0, 1, 2, 3), Wall)
        p = jnp.sum(jnp.abs(z) ** 2, axis=(3, 4))        # [B, n_cb, cell]
        metric = jnp.min(p, axis=-1)                     # [B, n_cb]
        return jnp.argmax(metric, -1), jnp.max(metric, -1)

    return search


def reports_from_cells(cells: np.ndarray, N_TS: int = 1,
                       reciprocal: bool = False) -> list[MimoReport]:
    """Codebook search on already-condensed cells [B, N_RX, N_TX, 4]
    (e.g. the `h_cells` output of phy.rx.build_rx)."""
    cells = np.asarray(cells)
    if reciprocal:
        cells = cells.transpose(0, 2, 1, 3)
    B, R, T, _ = cells.shape
    if (N_TS, T) not in CODEBOOK_SIZES:
        return [MimoReport(0, 0.0, N_TS, T) for _ in range(B)]
    idx, metric = (np.asarray(v) for v in _search_fn(N_TS, T)(cells))
    return [MimoReport(int(idx[i]), float(metric[i]), N_TS, T)
            for i in range(B)]


def estimate_mimo(h: np.ndarray, N_TS: int = 1,
                  reciprocal: bool = False) -> list[MimoReport]:
    """Codebook feedback from channel estimates h [B, N_RX, N_TX, n_subc].

    N_TS: stream count of the FUTURE beamformed transmission (1 for the
    closed-loop single-stream modes the reference searches). reciprocal=True
    transposes RX<->TX for our own transmit beamforming.
    """
    return reports_from_cells(condense_wideband(np.asarray(h)),
                              N_TS, reciprocal)


def estimate_aoa(h_ant: np.ndarray, array, freq_hz: float,
                 n_grid: int = 360) -> tuple[float, np.ndarray]:
    """Azimuth AoA from per-RX-antenna channel estimates.

    The reference declares this estimator but ships a 39-LoC stub
    (lib/src/phy/rx/rx_synced/aoa/estimator_aoa.cpp) — implemented here as
    a working capability: a Bartlett (conventional beamformer) spectrum
    over an azimuth grid using the array's steering vectors
    (radio/antenna_array.py).

    h_ant: [R] or [R, n_cells] complex per-antenna channel (e.g. the
    wideband condensation h_cells averaged over TS/cells). Returns
    (azimuth_rad, spectrum [n_grid]).
    """
    h = np.asarray(h_ant)
    if h.ndim == 1:
        h = h[:, None]                                     # [R, 1]
    Rxx = h @ h.conj().T                                   # [R, R]
    grid = np.linspace(-np.pi, np.pi, n_grid, endpoint=False)
    A = array.steering(grid, freq_hz)                      # [n_grid, R]
    spec = np.real(np.einsum("gr,rs,gs->g", A.conj(), Rxx, A))
    return float(grid[int(np.argmax(spec))]), spec
