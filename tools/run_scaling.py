"""Measure mesh scaling of the sharded runtime paths on a virtual CPU mesh.

Two sharded paths (SURVEY par. 2.9 mapping table):
  (a) time-axis sync sharding with ppermute halo exchange
      (phy/sync_sharded.py; reference worker_pool.cpp:249-324 chunked
      sync workers with 4-STF overlap)
  (b) vspace node sharding with psum superposition
      (simulation/vspace.py tick_sharded; reference vspace.cpp:195-253)

Run on the virtual CPU mesh (JAX_PLATFORMS=cpu,
--xla_force_host_platform_device_count=8). NOTE: this host has few physical
cores, so virtual-device wall clock does NOT demonstrate speedup — the
numbers recorded are (i) correctness-equivalent sharded execution at every
mesh size and (ii) the structural communication overhead (halo bytes /
chunk bytes), which bounds achievable scaling on a real interconnect. It
forces the CPU on purpose: it is a virtual-mesh tool; the 4-GPU run of the
same sharded paths is `chip_smoke.py --four-gpus`.

Usage: python tools/run_scaling.py [out.json]
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from dectnrp_tpu.common.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def _time(f, *args, iters=5):
    y = f(*args)
    jax.tree.map(lambda l: l.block_until_ready(), y)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = f(*args)
    jax.tree.map(lambda l: l.block_until_ready(), y)
    return (time.perf_counter() - t0) / iters * 1e3


def main() -> None:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "scaling_cpu_mesh.json"
    from dectnrp_tpu.phy.sync_sharded import build_sync_sharded
    from dectnrp_tpu.sections.part3.transmission_packet_structure import \
        get_N_samples_STF
    from dectnrp_tpu.simulation.vspace import tick_sharded

    res = {"host_cores": os.cpu_count(),
           "note": "virtual 8-device CPU mesh on a small host: validates "
                   "sharded execution + records structural comm overhead; "
                   "wall-clock speedup requires real chips"}

    # --- (a) time-axis sync sharding. chunk 8192 keeps the per-chunk
    # window redundancy (overlap/chunk) at 5.5% — the reference's chunk is
    # likewise configurable (rx_chunk_length_u8subslot, sync_param.hpp:77)
    u, b, chunk = 1, 1, 8192
    overlap = 4 * get_N_samples_STF(u, b)
    rng = np.random.default_rng(0)

    def _stream(T):
        return jnp.asarray((rng.standard_normal((1, T))
                            + 1j * rng.standard_normal((1, T))
                            ).astype(np.complex64))

    # strong scaling: constant total work (32 chunks), devices grow
    n_chunks = 32
    T = n_chunks * chunk
    iq = _stream(T)
    sync_rows = []
    for n_dev in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("t",))
        f = build_sync_sharded(u, b, chunk, n_chunks, mesh)
        ms = _time(f, iq)
        sync_rows.append({"n_dev": n_dev, "ms_per_stream": round(ms, 2),
                          "samples_per_s": round(T / (ms / 1e3)),
                          "chunks_per_dev": n_chunks // n_dev})
    res["sync_sharded_strong_cpu_mesh"] = sync_rows

    # weak scaling: FIXED work per device (4 chunks/dev); flat ms/stream as
    # devices grow = the honest scaling statement on a virtual mesh.
    # CONTROL: the same TOTAL work run UNSHARDED
    # on ONE device of the same host — on a 2-core box every virtual device
    # timeshares the same cores, so sharded/control separates structural
    # comm+partition overhead (what real chips would pay) from host
    # contention (an artifact of the virtual mesh).
    weak_rows = []
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("t",))
    for n_dev in (1, 2, 4, 8):
        nc = 4 * n_dev
        Tw = nc * chunk
        iqw = _stream(Tw)
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("t",))
        f = build_sync_sharded(u, b, chunk, nc, mesh)
        ms = _time(f, iqw)
        f1 = build_sync_sharded(u, b, chunk, nc, mesh1)
        ms_ctl = _time(f1, iqw)
        weak_rows.append({"n_dev": n_dev, "total_chunks": nc,
                          "ms_per_stream": round(ms, 2),
                          "ms_per_chunk_per_dev": round(ms / 4, 3),
                          "control_unsharded_1dev_ms": round(ms_ctl, 2),
                          "sharded_over_control": round(ms / ms_ctl, 3),
                          "samples_per_s": round(Tw / (ms / 1e3))})
    res["sync_sharded_weak_cpu_mesh"] = weak_rows
    c_loc = n_chunks // 8
    res["sync_halo_overhead"] = {
        "overlap_samples": overlap, "chunk_samples": chunk,
        "window_redundancy": round(overlap / chunk, 4),
        "ici_halo_fraction_8dev": round(overlap / (c_loc * chunk), 5),
        "comment": "each chunk's search window re-reads overlap/chunk = "
                   f"{overlap/chunk:.1%} extra samples locally (compute "
                   "redundancy); the ppermute moves only `overlap` samples "
                   "per shard boundary = "
                   f"{overlap/(c_loc*chunk):.2%} of shard bytes at 8 devices "
                   "(true ICI traffic)"}

    # --- (b) vspace node sharding (psum ether), 8 nodes, per-edge gains
    N, A, spp = 8, 1, 4096
    gain = jnp.asarray(rng.uniform(0.05, 1.0, (N, N)).astype(np.float32))
    tx = jnp.asarray((rng.standard_normal((N, A, spp))
                      + 1j * rng.standard_normal((N, A, spp))).astype(np.complex64))
    vs_rows = []
    mesh1n = Mesh(np.array(jax.devices()[:1]), ("node",))
    def step1(txs, key):
        return tick_sharded(mesh1n, txs, gain, 1e-6, key)
    ms_ctl = _time(jax.jit(step1), tx, jax.random.PRNGKey(0))
    for n_dev in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("node",))
        def step(txs, key, mesh=mesh):
            return tick_sharded(mesh, txs, gain, 1e-6, key)
        ms = _time(jax.jit(step), tx, jax.random.PRNGKey(0))
        vs_rows.append({"n_dev": n_dev, "ms_per_tick": round(ms, 3),
                        "control_unsharded_1dev_ms": round(ms_ctl, 3),
                        "sharded_over_control": round(ms / ms_ctl, 3),
                        "nodes_per_dev": N // n_dev})
    res["vspace_sharded_cpu_mesh"] = vs_rows
    res["structural_overhead"] = (
        "The halo exchange moves `overlap` samples per shard boundary = "
        f"{overlap/(4*chunk):.2%} of each shard's bytes at 4 chunks/dev, "
        "and each device re-computes overlap/chunk = "
        f"{overlap/chunk:.1%} extra window samples locally. The "
        "virtual-mesh wall clock in the rows above measures host-core "
        "contention, not communication.")

    with open(out_path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res["sync_sharded_strong_cpu_mesh"]))
    print(json.dumps(res["sync_sharded_weak_cpu_mesh"]))
    print(json.dumps(res["vspace_sharded_cpu_mesh"]))


if __name__ == "__main__":
    main()
