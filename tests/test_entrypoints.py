"""Entry points that measure the card refuse to run without one; every
entry point shares one persistent compile cache location."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entrypoint_refuses_cpu(script):
    r = _run([script], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert '"metric"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the repository beside it the script fails and prints no
    result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_compile_cache_honours_env(monkeypatch):
    import jax

    from dectnrp_tpu.common import jax_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert jax_cache.enable_compile_cache() == "/some/where"
    assert calls == []                   # JAX reads the variable itself


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    import jax

    from dectnrp_tpu.common import jax_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = jax_cache.enable_compile_cache()
    assert Path(d) == REPO / ".jax_cache"
    assert calls == [("jax_compilation_cache_dir", d)]
    assert jax_cache.enable_compile_cache() == d      # same path every run
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
