"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use.

Each source is compiled on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``)
and loaded with ``ctypes``; no PyTorch headers are involved, so a build
takes seconds.  Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of their
source and flags so an edited source is rebuilt.  :func:`build` starts
one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

__all__ = ["SOURCES", "build", "load", "build_dir", "ptxas_report",
           "sass_counts"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "aes_ctr": "aes_ctr.cu",
    "fused_crypt_mac": "fused_crypt_mac.cu",
    "otp_xor": "otp_xor.cu",
    "xormac": "xormac.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> the checkout root.
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources that are not built yet, in parallel.

    Returns ``{name: path}``; raises with nvcc's output if one fails.
    """
    names = list(SOURCES) if names is None else list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        log = open(target.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT), tmp, target, log)
    failed = []
    for name, (proc, tmp, target, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, target)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{target.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` output (registers, shared memory, spills)
    from the build of ``name``; empty if it was built elsewhere."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass_counts(name: str) -> dict:
    """``{kernel symbol: {"instructions": n, opcode: n, ...}}`` from
    ``cuobjdump -sass`` of the built library of ``name``; empty where
    the toolkit has no ``cuobjdump``."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(build([name])[name])],
                          capture_output=True, text=True, timeout=120).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = counts.setdefault(head.group(1), Counter())
            continue
        inst = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                        line)
        if fn is not None and inst:
            fn["instructions"] += 1
            fn[inst.group(1)] += 1
    return {k: dict(v) for k, v in counts.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, building it first if needed."""
    if name not in _LIBS:
        path = build([name])[name]
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
