"""Virtual space: lock-step superposition of all simulated nodes' TX streams.

TPU-native counterpart of reference lib/src/simulation/vspace.cpp:159-267.
The reference lock-steps N hw_simulator pthreads exchanging one spp (sample
packet, e.g. 200 us) per tick through a mutex/cv-guarded exchange; here a
tick is ONE jit call over the stacked [N, A, spp] tensor: every node's RX is
the superposition of all other nodes' TX through the per-edge channel
(complete graph, awgn/flat/doubly) + pathloss, plus its own TX leakage
(intra channel) and thermal noise. Global time advances spp samples per tick.

For mesh execution, `tick_sharded` shards the node axis and realizes the
superposition as a psum over it (SURVEY.md par. 2.9 mapping).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .channels import doubly_selective
from .topology import Position, Trajectory, fspl_db


@dataclass
class VNodeConfig:
    n_ant: int = 1
    trajectory: Trajectory = field(default_factory=Trajectory)
    tx_leakage_db: float = float("inf")     # inf = no TX->RX leakage
    noise_figure_db: float = 0.0


@dataclass
class VSpaceConfig:
    samp_rate: float
    spp_len: int
    freq_hz: float = 1.9e9
    channel_inter: str = "awgn"             # awgn | flat | doubly_<pdp>_<tau_ns>_<fd>
    channel_intra: str = "awgn"
    noise_var: float = 0.0                  # per-sample RX noise variance
    sim_seed: int = 0


def noise_var_from_snr_net_bw(snr_db: float, net_bandwidth_norm: float) -> float:
    """reference noise.cpp: n0_dB = -10 log10(net_bw_norm) - snr (signal = 1)."""
    n0_db = -10.0 * np.log10(net_bandwidth_norm) - snr_db
    return float(10.0 ** (n0_db / 10.0))


def _parse_doubly(name: str):
    _, pdp, tau, fd = name.split("_")
    return int(pdp), float(tau) * 1e-9, float(fd)


class VSpace:
    """N-node virtual ether; call tick(tx_spps) per spp period."""

    def __init__(self, cfg: VSpaceConfig, nodes: list[VNodeConfig]):
        self.cfg = cfg
        self.nodes = nodes
        self.N = len(nodes)
        self.A = max(n.n_ant for n in nodes)
        self.now = 0                 # global sample counter
        self._key = jax.random.PRNGKey(cfg.sim_seed)
        self._edge_H = None          # static flat-fading edge matrices
        self._edge_H_host = None     # host copy (complex-free boundary)

        if cfg.channel_inter == "flat":
            # host-side draw: complex64 must not touch the device eagerly
            r = np.random.default_rng(cfg.sim_seed ^ 0xF1A7)
            Hs = (r.standard_normal((self.N, self.N, self.A, self.A))
                  + 1j * r.standard_normal((self.N, self.N, self.A, self.A)))
            Hs = (Hs / np.sqrt(2.0)).astype(np.complex64)
            # reciprocity: H_ij = H_ji^T (reference link_t primary/secondary)
            iu = np.triu_indices(self.N, 1)
            Hs[iu[1], iu[0]] = np.swapaxes(Hs[iu[0], iu[1]], -1, -2)
            self._edge_H = Hs
            self._edge_H_host = Hs

        # pathloss amplitude gains per directed edge, updated per tick
        self._gain = np.ones((self.N, self.N), np.float32)

    def _update_gains(self) -> None:
        t_s = self.now / self.cfg.samp_rate
        pos = [n.trajectory.position_at(t_s) for n in self.nodes]
        for i in range(self.N):
            for j in range(self.N):
                if i == j:
                    leak = self.nodes[i].tx_leakage_db
                    self._gain[i, j] = 0.0 if np.isinf(leak) \
                        else 10.0 ** (-leak / 20.0)
                else:
                    pl = fspl_db(pos[i].distance(pos[j]), self.cfg.freq_hz)
                    self._gain[i, j] = 10.0 ** (-pl / 20.0)

    def tick(self, tx_spps) -> np.ndarray:
        """tx_spps [N, A, spp] -> rx_spps [N, A, spp] (host complex64);
        advances global time."""
        assert tx_spps.shape == (self.N, self.A, self.cfg.spp_len)
        self._update_gains()
        key = jax.random.fold_in(self._key, self.now & 0x7FFFFFFF)
        if self._edge_H_host is None and self._edge_H is not None:
            self._edge_H_host = np.asarray(self._edge_H)
        rx = _tick_host(tx_spps, self._gain, self._edge_H_host, key,
                        self.cfg.noise_var, self.cfg.channel_inter,
                        self.cfg.samp_rate)
        self.now += self.cfg.spp_len
        return rx


@lru_cache(maxsize=None)
def _tick_compiled(channel_inter: str, samp_rate: float, noise_var: float):
    return jax.jit(partial(_tick_jit, channel_inter=channel_inter,
                           samp_rate=samp_rate, noise_var=noise_var))


def _tick_host(tx, gain, edge_H, key, noise_var, channel_inter, samp_rate):
    f = _tick_compiled(channel_inter, float(samp_rate), float(noise_var))
    return np.asarray(f(tx, gain, edge_H, key))


def _tick_jit(tx, gain, edge_H, key, *, channel_inter, samp_rate, noise_var):
    N, A, S = tx.shape
    if channel_inter == "awgn" or edge_H is None and not \
            channel_inter.startswith("doubly"):
        # rx_i = sum_j gain[j, i] * tx_j  (identity antenna mapping)
        rx = jnp.einsum("ji,jas->ias", gain.astype(jnp.complex64), tx)
    elif channel_inter == "flat":
        rx = jnp.einsum("ji,jiab,jbs->ias", gain.astype(jnp.complex64),
                        edge_H, tx)
    else:
        pdp, tau, fd = _parse_doubly(channel_inter)
        # per directed edge doubly-selective; key is deterministic per edge so
        # the channel is continuous in distribution across ticks
        def edge(i, j, k):
            y = doubly_selective(k, tx[j][None], A, samp_rate,
                                 tau_rms_s=tau, doppler_hz=fd, pdp_idx=pdp)
            return y[0]
        rows = []
        for i in range(N):
            acc = jnp.zeros((A, S), jnp.complex64)
            for j in range(N):
                k = jax.random.fold_in(jax.random.fold_in(key, i * 131 + j), 7)
                acc = acc + gain[j, i] * edge(i, j, k)
            rows.append(acc)
        rx = jnp.stack(rows)
    if noise_var > 0.0:
        k1, k2 = jax.random.split(key)
        n = (jax.random.normal(k1, rx.shape) + 1j * jax.random.normal(k2, rx.shape))
        rx = rx + jnp.sqrt(noise_var / 2.0) * n.astype(jnp.complex64)
    return rx


def tick_sharded(mesh, tx_spps, gain, noise_var, key):
    """Mesh-sharded vspace tick: node axis sharded, superposition via psum.

    tx_spps [N, A, spp] sharded over mesh axis "node"; each shard computes its
    node's weighted contribution and a psum over "node" realizes the ether
    (SURVEY.md par. 2.9: all-to-all sample exchange -> all_gather/psum).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    N = tx_spps.shape[0]

    @partial(shard_map, mesh=mesh,
             in_specs=(P("node"), P(None), P()),
             out_specs=P("node"), check_vma=False)
    def step(tx_l, gain_all, k):
        # tx_l [N/n_shards, A, spp]; this shard's nodes' indices
        idx = jax.lax.axis_index("node")
        n_local = tx_l.shape[0]
        # contribution of local nodes to EVERY receiver: [N, A, spp]
        g = jax.lax.dynamic_slice_in_dim(
            gain_all, idx * n_local, n_local, axis=0)     # [n_local, N]
        contrib = jnp.einsum("ji,jas->ias", g.astype(jnp.complex64), tx_l)
        ether = jax.lax.psum(contrib, "node")             # [N, A, spp]
        mine = jax.lax.dynamic_slice_in_dim(
            ether, idx * n_local, n_local, axis=0)
        k1, k2 = jax.random.split(jax.random.fold_in(k, idx))
        n = (jax.random.normal(k1, mine.shape)
             + 1j * jax.random.normal(k2, mine.shape))
        return mine + jnp.sqrt(noise_var / 2.0) * n.astype(jnp.complex64)

    return step(tx_spps, gain, key)
