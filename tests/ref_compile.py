"""Helpers to compile & run the *reference* C programs as parity oracles.

The reference's only configuration mechanism is compile-time #define
patching (src/run.py:26-61); we do the equivalent here to build test
binaries against generated fixtures.  Nothing from the reference is copied
into the framework — binaries are built in tmpdirs at test time and used
solely as golden outputs (the reference's own verification methodology,
README.md:71).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import numpy as np

REF = "/root/reference"

SOURCES = {
    "flash": f"{REF}/src/FLASH_Viterbi_multithread.c",
    "flash_bs": f"{REF}/src/FLASH_BS_Viterbi_multithread.c",
    "vanilla": f"{REF}/Base_line/C implementations/vanilla Viterbi.c",
    "checkpoint": f"{REF}/Base_line/C implementations/checkpoint Viterbi.c",
    "sieve_mp": f"{REF}/Base_line/C implementations/SIEVE-Mp.c",
    "sieve_bs": f"{REF}/Base_line/C implementations/SIEVE-BS.c",        # needs glib
    "sieve_bs_mp": f"{REF}/Base_line/C implementations/SIEVE-BS-Mp.c",  # needs glib
}

NEEDS_GLIB = {"sieve_bs", "sieve_bs_mp"}


def have_gcc() -> bool:
    return shutil.which("gcc") is not None


def have_reference() -> bool:
    """The reference checkout these helpers compile from is present."""
    return os.path.isdir(REF)


_GLIB_SHIM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "csrc", "glibshim")


def have_real_glib() -> bool:
    try:
        subprocess.run(["pkg-config", "--exists", "glib-2.0"], check=True,
                       capture_output=True)
        return True
    except Exception:
        return False


def have_glib() -> bool:
    """Real glib-2.0 or the vendored single-header shim (csrc/glibshim)."""
    return have_real_glib() or os.path.exists(os.path.join(_GLIB_SHIM, "glib.h"))


def patch_source(src: str, K: int, M: int, T: int, prob: float, data_path: str,
                 threads: int | None = None, beam: int | None = None) -> str:
    text = open(src).read()
    text = re.sub(r"#define K_STATE \d+", f"#define K_STATE {K}", text)
    text = re.sub(r"#define T_STATE \d+", f"#define T_STATE {M}", text)
    text = re.sub(r"#define obserRouteLEN \d+", f"#define obserRouteLEN {T}", text)
    text = re.sub(r"const float prob = [\d.]+;", f"const float prob = {prob};", text)
    text = re.sub(r'const char data_path\[\] = "[^"]*";',
                  f'const char data_path[] = "{data_path}/";', text)
    if threads is not None:
        text = re.sub(r"#define MAX_THREADS \d+", f"#define MAX_THREADS {threads}", text)
    if beam is not None:
        text = re.sub(r"const int BeamSearchWidth = \d+;",
                      f"const int BeamSearchWidth = {beam};", text)
    dec = len(str(prob).split(".")[1]) if "." in str(prob) else 0
    text = re.sub(r"prob%\.\d+f", f"prob%.{dec}f", text)
    return text


def build_and_run(name: str, workdir: str, K: int, M: int, T: int, prob: float,
                  data_path: str, threads: int | None = None,
                  beam: int | None = None, timeout: int = 600) -> np.ndarray:
    """Compile the patched reference program and return its decoded path."""
    src_text = patch_source(SOURCES[name], K, M, T, prob, data_path, threads, beam)
    cfile = os.path.join(workdir, f"{name}.c")
    binfile = os.path.join(workdir, f"{name}.bin")
    with open(cfile, "w") as f:
        f.write(src_text)
    cmd = ["gcc", "-O2", "-pthread", cfile, "-o", binfile, "-lm",
           "-Wl,-z,stack-size=268435456"]
    if name in NEEDS_GLIB:
        if have_real_glib():
            flags = subprocess.run(["pkg-config", "--cflags", "--libs", "glib-2.0"],
                                   capture_output=True, text=True, check=True)
            cmd = cmd[:-2] + flags.stdout.split() + cmd[-2:]
        else:
            cmd.insert(1, f"-I{_GLIB_SHIM}")  # vendored minimal glib shim
    subprocess.run(cmd, check=True, capture_output=True)
    out = subprocess.run([binfile], capture_output=True, text=True, check=True,
                         timeout=timeout).stdout
    m = re.search(r"path: \[([^\]]*)\]", out)
    assert m, f"no path in reference output: {out[:500]}"
    return np.array([int(x) for x in m.group(1).split()], dtype=np.int64)


def build_and_run_timed(name: str, workdir: str, K: int, M: int, T: int,
                        prob: float, data_path: str,
                        threads: int | None = None, beam: int | None = None,
                        timeout: int = 1200) -> float:
    """Compile + run the reference program and return its own reported
    decode time (the ``time: %lf`` line, which excludes data loading —
    src/FLASH_Viterbi_multithread.c:373-378)."""
    src_text = patch_source(SOURCES[name], K, M, T, prob, data_path,
                            threads, beam)
    cfile = os.path.join(workdir, f"{name}.c")
    binfile = os.path.join(workdir, f"{name}.bin")
    with open(cfile, "w") as f:
        f.write(src_text)
    cmd = ["gcc", "-O2", "-pthread", cfile, "-o", binfile, "-lm",
           "-Wl,-z,stack-size=268435456"]
    if name in NEEDS_GLIB:
        if have_real_glib():
            flags = subprocess.run(
                ["pkg-config", "--cflags", "--libs", "glib-2.0"],
                capture_output=True, text=True, check=True)
            cmd = cmd[:-2] + flags.stdout.split() + cmd[-2:]
        else:
            cmd.insert(1, f"-I{_GLIB_SHIM}")
    subprocess.run(cmd, check=True, capture_output=True)
    out = subprocess.run([binfile], capture_output=True, text=True,
                         check=True, timeout=timeout).stdout
    tm = re.search(r"time: ([\d.eE+-]+)", out)
    assert tm, f"no time in reference output: {out[:500]}"
    return float(tm.group(1))


def build_and_run_full(name: str, workdir: str, K: int, M: int, T: int,
                       prob: float, data_path: str, threads: int | None = None,
                       beam: int | None = None):
    """Like build_and_run but also returns the reported ``memory:`` figure."""
    path = build_and_run(name, workdir, K, M, T, prob, data_path, threads, beam)
    out = subprocess.run([os.path.join(workdir, f"{name}.bin")],
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout
    mm = re.search(r"memory: (\d+)", out)
    assert mm, f"no memory in reference output: {out[:500]}"
    return path, int(mm.group(1))
