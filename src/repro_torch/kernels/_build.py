"""Build and bind the hand-written CUDA kernels.

The sources under `repro_torch/csrc/` are compiled at first use with
`nvcc` for Hopper (`sm_90a`) into one shared library with a plain C
interface, `build/repro_torch/libteda_kernels.so` at the repository
root, and bound with `ctypes`.  Each source compiles in its own `nvcc`
process, all started together, and one more `nvcc` links them.  The
library is rebuilt when any source is newer than it.  Nothing here runs
at import time: the CPU tests import every module on machines without
`nvcc`.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "LIB_PATH", "build", "library", "check",
           "sass_stats"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_PATH = BUILD_DIR / "libteda_kernels.so"
SOURCES = ("teda_scan.cu", "teda_q_scan.cu", "ensemble_scan.cu",
           "qdiv_probe.cu")
HEADERS = ("qformat.cuh", "device_guard.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: it changes division and denormals on the float path
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_V = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
SIGNATURES = {
    "teda_scan_f32": [_V] * 13 + [_LL, _LL, _I, _I, _V],
    "teda_q_scan_i32": [_V] * 13 + [_LL, _LL, _I, _I, _I, _I, _I, _V],
    "ensemble_scan_f32": [_V] * 12 + [_LL, _LL] + [_I] * 14 + [_V],
    "qdiv_probe_u32": [_V] * 3 + [_LL, _I, _I, _I, _I, _V],
}

_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "repro_torch are built from source at first use")
    return found


def _stale() -> bool:
    if not LIB_PATH.is_file():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((CSRC / f).stat().st_mtime > built
               for f in SOURCES + HEADERS)


def build(force: bool = False) -> dict:
    """Compile the kernels if the library is missing or stale.

    Returns {"path", "seconds", "built", "log"}: `log` holds nvcc's
    output, including `-Xptxas -v`'s registers and spills per kernel.
    Raises RuntimeError with nvcc's output if a compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not _stale():
            return {"path": str(LIB_PATH), "seconds": 0.0, "built": False,
                    "log": ""}
        nvcc = nvcc_path()
        procs, objs = [], []
        for src in SOURCES:
            obj = BUILD_DIR / (Path(src).stem + ".o")
            objs.append(str(obj))
            cmd = [nvcc, *ARCH, *FLAGS, "-Xptxas", "-v", "-c",
                   str(CSRC / src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}"
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{res.stdout}")
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp, LIB_PATH)
    return {"path": str(LIB_PATH), "seconds": time.perf_counter() - t0,
            "built": True, "log": "\n".join(logs)}


def library() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def sass_stats(path=LIB_PATH) -> dict:
    """Static SASS instruction counts of each kernel in a built library,
    from `cuobjdump -sass` beside nvcc: {mangled name: {"instructions":
    n, "loops": [instructions in each loop body, innermost first]}},
    NOPs left out.  A loop is a backward branch; its body runs from the
    branch target to the branch.  Empty when cuobjdump is missing."""
    exe = Path(nvcc_path()).with_name("cuobjdump")
    if not exe.is_file():
        found = shutil.which("cuobjdump")
        if found is None:
            return {}
        exe = Path(found)
    out = subprocess.run([str(exe), "-sass", str(path)], check=True,
                         capture_output=True, text=True).stdout
    stats, fn = {}, None
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = {"ins": [], "labels": {}}
            stats[head.group(1)] = fn
            continue
        if fn is None:
            continue
        label = re.match(r"\s*\.(L_x_\d+):", line)
        if label:
            fn["labels"][label.group(1)] = len(fn["ins"])
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if ins and not ins.group(2).strip().startswith("NOP"):
            fn["ins"].append((int(ins.group(1), 16), ins.group(2)))
    result = {}
    for name, fn in stats.items():
        addr = {a: i for i, (a, _) in enumerate(fn["ins"])}
        loops = []
        for i, (_, text) in enumerate(fn["ins"]):
            tgt = re.search(r"BRA\s+(?:`\(\.(L_x_\d+)\)|(0x[0-9a-f]+))",
                            text)
            if tgt is None:
                continue
            j = (fn["labels"].get(tgt.group(1)) if tgt.group(1)
                 else addr.get(int(tgt.group(2), 16)))
            if j is not None and j < i:
                loops.append(i - j + 1)
        result[name] = {"instructions": len(fn["ins"]),
                        "loops": sorted(loops)}
    return result
