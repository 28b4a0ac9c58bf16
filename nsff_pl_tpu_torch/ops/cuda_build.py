"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles with
`nvcc` alone (no PyTorch headers, so a build takes seconds) into
`nsff_pl_tpu_torch/_build/lib<name>_<hash>.so`, keyed by the content hash
of the source, the shared headers (`csrc/*.cuh`) and the flags. `build()` starts one `nvcc` per source, all at once. A
build failure raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from nsff_pl_tpu_torch.ops.raymarch_kernel import MAX_FREQS

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -lcuda: the evaluators encode their TMA tensor maps with the driver API
# (cuTensorMapEncodeTiled); NSFF_MAX_FREQS: the posenc frequencies the
# one-segment kernels take (csrc/planar_tower.cuh's MAXF), their wrappers'
# own bound
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lcuda", f"-DNSFF_MAX_FREQS={MAX_FREQS}"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (CUDA toolkit needed to build "
                           "the kernels in nsff_pl_tpu_torch/csrc)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    concurrent `nvcc` each. The compiler's register/spill report goes to
    `<library>.log` beside the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        so = library_path(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, out[name])
    if failed:
        tails = "\n".join(
            f"--- {n} ---\n" + out[n].with_suffix(".log").read_text()[-4000:]
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{tails}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
