"""Build the CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with one `nvcc` call into
`build/<name>-<hash>.so` at the repo root, a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The hash covers
the source, every header of `csrc/` (`*.cuh`) and the flags, so an edited
kernel or header is rebuilt and an unchanged one is reused. `build()`
starts one `nvcc` per missing library, all at once. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
KERNELS = ("bank_attention_bwd", "bank_attention_bwd_fused",
           "bank_attention_infer", "bank_attention_infer_v128",
           "bank_attention_lse_v128",
           "bank_attention_mh", "bank_attention_mh_bwd", "gated_dwconv",
           "jpeg_color", "local_attention", "stem")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile the libraries that are missing, one nvcc each, in parallel.
    The compiler's register and shared-memory report goes beside each
    library as `<lib>.log`. Raises with the compiler's output on failure."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
