"""Build the port's CUDA sources (``gnn_rul_tpu_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, in ``build/`` at the repository root and
named by a hash of the source and the headers beside it (``csrc/*.cuh``),
so an unchanged source is built once. The sources not yet built are
compiled together, one ``nvcc`` each. The wrappers in this package load the
libraries with ``ctypes`` at first use. :func:`build_variant` builds one
source with a macro defined into a library of its own, which no wrapper
loads (``chip_smoke.py``'s step-phase stamps of kernel #4).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

from ...telemetry import count

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"nvcc not found: the kernels under {CSRC} are built "
                       "with the CUDA toolkit")


def _library_path(source: Path, variant: str = "") -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}{variant}_{digest}.so"


def _nvcc_cmd(source: Path, out: Path, defines=()) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            *(f"-D{d}" for d in defines), "-Xptxas", "-v", "-o", str(out),
            str(source)]


def build_libraries() -> Dict[str, Tuple[Path, str]]:
    """Compile every source under ``csrc/`` whose library is not in
    ``build/`` yet, all at once. Returns ``{source stem: (library path,
    nvcc's -Xptxas -v log)}``; the log is empty for a library that was
    already built. Raises if any build fails, after every nvcc has ended.
    Adds the nvcc runs to the counter ``kernels.compiled``
    (``telemetry.cold_start``)."""
    built: Dict[str, Tuple[Path, str]] = {}
    jobs = []
    for source in sorted(CSRC.glob("*.cu")):
        lib = _library_path(source)
        if lib.exists():
            built[source.stem] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.so")
        cmd = _nvcc_cmd(source, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source.stem, lib, tmp, cmd, proc))
    count("kernels.compiled", len(jobs))
    failed = []
    for stem, lib, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{log}")
            continue
        os.replace(tmp, lib)
        built[stem] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def build_variant(stem: str, define: str) -> Path:
    """``csrc/<stem>.cu`` compiled with ``-D<define>`` into its own library,
    ``build/<stem>_<define lowercased>_<digest>.so``, once per source and
    headers; returns its path. Raises if nvcc fails."""
    source = CSRC / f"{stem}.cu"
    lib = _library_path(source, "_" + define.lower())
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.so")
        cmd = _nvcc_cmd(source, tmp, (define,))
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, lib)
    return lib
