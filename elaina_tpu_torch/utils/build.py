"""Build native shared libraries from the checkout's sources at first use.

Outputs go to ``elaina_tpu_torch/_build/`` (listed in .gitignore), named by
a hash of the compiler command and the sources, so a changed source or
flag builds anew and an unchanged one is reused.  Concurrent builders
(test workers) take a file lock, so one of them compiles and the others
find its output; the output is published with an atomic rename.  A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def build_shared(name: str, compiler: list[str], sources: list[str],
                 flags: list[str], headers: tuple = ()) -> str:
    """Compile ``sources`` into ``_build/lib<name>-<hash>.so``; return it.
    ``headers`` are the files the sources include: they enter the hash."""
    h = hashlib.sha1(" ".join(compiler + flags).encode())
    for src in list(sources) + list(headers):
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):          # another process built it
            return out
        tmp = f"{out[:-3]}.tmp{os.getpid()}.so"
        cmd = compiler + flags + ["-o", tmp] + sources
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"build of {name} failed ({' '.join(cmd)}):"
                               f"\n{proc.stdout}{proc.stderr}")
        with open(out + ".log", "w") as f:  # compiler notes (ptxas -v)
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out
