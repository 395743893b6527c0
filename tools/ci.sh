#!/bin/sh
# CI entry (reference analog: CTest + ASAN/TSAN/valgrind lattice,
# CMakeLists.txt:59-78,263-265 — here: bytecode check and the CPU-mesh
# suite, all in this one process chain; the on-card checks are
# chip_smoke.py, run on a machine with a GPU).
set -e
cd "$(dirname "$0")/.."

echo "== compileall (syntax/bytecode)"
python -m compileall -q dectnrp_tpu tools tests bench.py chip_smoke.py __graft_entry__.py

echo "== unit+system suite (virtual 8-dev CPU mesh)"
python -m pytest tests/ -q

echo "CI OK"
