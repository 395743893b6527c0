"""Multi-host (DCN) code path, virtually: a jax.distributed two-process run.

SURVEY par. 2.9 / par. 7 stage 9 call for sharding INDEPENDENT channels/nodes
across hosts over DCN (the reference has no multi-host story at all — its
parallelism is pthreads in one process). Real multi-host hardware is not
available in this environment, so this tool proves the code path exists and
executes: two OS processes, each with its own CPU devices, joined by
`jax.distributed.initialize` into one global mesh; the vspace ether tick
(simulation/vspace.py tick_sharded: per-edge-weighted psum over the "node"
axis) and a cross-node loopback decode run over that process-spanning mesh,
with the node axis deliberately split so every psum crosses the process
boundary (= would ride DCN on real hosts).

Parent mode (default): spawns the two children, collects their reports and
writes results/dcn/DCN_<tag>.json.
Child mode (--proc I): runs the distributed program.

The children run on the CPU on purpose (a virtual multi-host mesh), so
spawning two JAX processes here never puts a second process on a GPU.

Usage: python tools/run_dcn_dryrun.py [--tag r04]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COORD = "localhost:12355"
N_PROC = 2
LOCAL_DEV = 2                      # CPU devices per process -> 4 global


def child(proc_id: int) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={LOCAL_DEV}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dectnrp_tpu.common.jax_cache import enable_compile_cache
    enable_compile_cache()
    jax.distributed.initialize(coordinator_address=COORD,
                               num_processes=N_PROC, process_id=proc_id)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu.sections.part3.packet_sizes import (PacketSizesDef,
                                                         get_packet_sizes)
    from dectnrp_tpu.simulation.vspace import tick_sharded

    n_dev = N_PROC * LOCAL_DEV
    assert len(jax.devices()) == n_dev, jax.devices()
    mesh = Mesh(np.array(jax.devices()), ("node",))
    sh_node = NamedSharding(mesh, P("node"))
    sh_rep = NamedSharding(mesh, P())

    # --- (a) the raw ether tick across the process boundary
    N, A, spp = n_dev, 1, 2048
    rng = np.random.default_rng(0)
    gain_h = rng.uniform(0.5, 1.0, (N, N)).astype(np.float32)
    tx_h = (rng.standard_normal((N, A, spp))
            + 1j * rng.standard_normal((N, A, spp))).astype(np.complex64)

    def gshard(arr, sh):
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    tx_g = gshard(tx_h, sh_node)
    gain_g = gshard(gain_h, sh_rep)
    rx_g = tick_sharded(mesh, tx_g, gain_g, 1e-6, jax.random.PRNGKey(0))
    # local check: every local shard equals the host-side superposition
    want = np.einsum("ji,jas->ias", gain_h, tx_h)
    err = 0.0
    for s in rx_g.addressable_shards:
        i = s.index[0].start
        got = np.asarray(s.data)
        # noise_var 1e-6 -> tolerance dominated by the injected noise
        err = max(err, float(np.max(np.abs(got - want[s.index]))))
    assert err < 0.02, err

    # --- (b) independent channels sharded over the process mesh: each node
    # decodes its own loopback packet; the OK reduction crosses processes
    psdef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    ps = get_packet_sizes(psdef)
    nid = 0x12345678
    tx = build_tx(psdef, nid, 1)
    rx = build_rx(psdef, nid, 1)
    plcf_h = rng.integers(0, 2, (n_dev, 40)).astype(np.uint8)
    tb_h = rng.integers(0, 2, (n_dev, ps.N_TB_bits)).astype(np.uint8)
    plcf_g = gshard(plcf_h, sh_node)
    tb_g = gshard(tb_h, sh_node)

    @jax.jit
    def chan_step(plcf_bits, tb_bits):
        flags = jnp.zeros((plcf_bits.shape[0],), bool)
        iq = tx(plcf_bits, tb_bits, flags, flags)
        nv = jnp.float32(10.0 ** (-15.0 / 10.0))
        key = jax.random.PRNGKey(3)
        n = (jax.random.normal(key, iq.shape)
             + 1j * jax.random.normal(jax.random.fold_in(key, 1), iq.shape))
        y = iq + jnp.sqrt(nv / 2.0) * n.astype(jnp.complex64)
        out = rx(y, nv)
        return jnp.sum(out["tb_ok"].astype(jnp.int32))     # global reduction

    t0 = time.perf_counter()
    n_ok = int(jax.device_get(chan_step(plcf_g, tb_g)))
    dt = time.perf_counter() - t0
    rec = {"process_id": proc_id, "process_count": jax.process_count(),
           "global_devices": n_dev,
           "local_devices": len(jax.local_devices()),
           "ether_max_err": round(err, 5),
           "channels_decoded_ok": n_ok, "channels_total": n_dev,
           "chan_step_s": round(dt, 2)}
    assert n_ok == n_dev, rec
    print("DCNCHILD " + json.dumps(rec), flush=True)
    jax.distributed.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="r04")
    ap.add_argument("--proc", type=int, default=None)
    args = ap.parse_args()
    if args.proc is not None:
        child(args.proc)
        return

    # CPU-only workers (child() forces jax_platforms=cpu): two JAX
    # processes never share a GPU
    env = dict(os.environ)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--proc", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(N_PROC)]
    reports, logs = [], []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        logs.append(out)
        for line in out.splitlines():
            if line.startswith("DCNCHILD "):
                reports.append(json.loads(line[len("DCNCHILD "):]))
    ok = (len(reports) == N_PROC
          and all(p.returncode == 0 for p in procs)
          and all(r["channels_decoded_ok"] == r["channels_total"]
                  for r in reports))
    rec = {"tag": args.tag, "n_processes": N_PROC,
           "local_devices_per_process": LOCAL_DEV,
           "reports": reports, "ok": ok}
    if not ok:
        rec["logs_tail"] = [l[-2000:] for l in logs]
    out_path = f"results/dcn/DCN_{args.tag}.json"
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"ok": ok, "out": out_path}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
