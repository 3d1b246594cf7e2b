"""Scripts and helpers around the decoders: chip_smoke.py and bench.py refuse
to run without a GPU, the compile-cache location, and the scaling CLI."""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _last_line(text):
    lines = text.strip().splitlines()
    return lines[-1] if lines else ""


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot import the
    package, so it fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu_without_flag():
    r = _run(["bench.py", "--smoke"])
    assert r.returncode != 0
    assert "no GPU" in r.stderr and r.stdout.strip() == ""


def test_bench_cpu_flag_runs_smoke():
    r = _run(["bench.py", "--smoke", "--cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    row = json.loads(_last_line(r.stdout))
    assert row["exact_path_parity"] is True
    assert row["device"]["platform"] == "cpu"


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    import jax

    from flash_viterbi_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import jax

    from flash_viterbi_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert cache.compile_cache_dir() == path  # same path every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_never_temporary(monkeypatch):
    from flash_viterbi_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compile_cache_dir()
    assert not path.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_scaling_needs_a_rate(capsys):
    from flash_viterbi_tpu.cli import main

    assert main(["scaling", "--link", "4.5e11", "--mesh", "1,2,2"]) == 2
    assert main(["scaling", "--link", "4.5e11", "--rate", "8.4e11",
                 "--mesh", "1,2,2;2,2,1"]) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    assert [(r["n_data"], r["n_seq"], r["n_state"]) for r in rows] == [
        (1, 2, 2), (2, 2, 1)]
    assert all(0 < r["modeled_efficiency"] <= 1 for r in rows)


@pytest.mark.parametrize("argv", [["scaling", "--rate", "1e12"]])
def test_cli_scaling_link_required(argv):
    from flash_viterbi_tpu.cli import main

    with pytest.raises(SystemExit):
        main(argv)
