"""Scenario runner CLI (reference apps/dectnrp/dectnrp.cpp): loads a
scenario directory (radio.json + phy.json + upper.json), builds the full
radio -> phy -> upper stack against the virtual ether and runs it for a
given number of ticks (or until ctrl+c), then prints per-node stats.
"""
from __future__ import annotations

import argparse
import json


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="DECT NR+ scenario runner")
    ap.add_argument("scenario", help="scenario directory with "
                    "radio.json/phy.json/upper.json")
    ap.add_argument("--ticks", type=int, default=0,
                    help="number of lock-step spp ticks (0 = until ctrl+c)")
    a = ap.parse_args(argv)

    from ..common.jax_cache import enable_compile_cache
    from ..config import build_scenario, load_scenario
    enable_compile_cache()
    sc = load_scenario(a.scenario)
    run = build_scenario(sc)
    print(f"scenario {sc.name}: {len(run.hws)} node(s), "
          f"{[t['firmware'] for t in sc.upper.tpoints]}")
    try:
        if a.ticks > 0:
            run.run_ticks(a.ticks)
        else:
            while True:
                run.tick()
    except KeyboardInterrupt:
        pass
    for i, rt in enumerate(run.runtimes):
        fw = run.firmwares[i]
        stats = getattr(fw, "stats", None)
        print(json.dumps({"node": i, "runtime": vars(rt.stats),
                          "firmware": stats if isinstance(stats, dict)
                          else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
