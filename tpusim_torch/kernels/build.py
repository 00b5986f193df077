"""Builds the CUDA sources of the port at first use and loads them with ctypes.

Each source under tpusim_torch/csrc/ is compiled by nvcc for sm_90a into a
shared library with a plain C interface, under tpusim_torch/_build/ (named by
a hash of the source and the flags, so an edit rebuilds and an unchanged
source is loaded as it is). Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# every C entry point and its argument types: pointers and the stream are
# c_void_p (a 64-bit address), counts and flags c_int
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES: Dict[str, Dict[str, list]] = {
    "fastscan.cu": {
        "tpusim_fastscan_chunk": [
            _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
            _P, _P, _P, _P, _I, _I, _I,
            # pod groups: gpad, pres_row, flags, zone_id, n_zones, zone_ok,
            # vol_tbl, vol_w, vol_type, n_vols, uv_row, three limits
            _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
            # inter-pod: k_keys, d_doms, ta, tb, tp, hard_weight, topo,
            # ipod, wip, exist, pd, dpad
            _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I,
            # policy: header, label, label priority, image, NoExecute,
            # ServiceAntiAffinity domain and ServiceAffinity value tables
            _P, _P, _P, _P, _P, _P, _P,
            # the geometry: cluster, threads, dynamic shared bytes, whether
            # they hold the scratch; stream
            _I, _I, _I, _I, _P],
        # variant, cluster, threads, dynamic shared bytes
        "tpusim_fastscan_max_clusters": [_I, _I, _I, _I],
    },
    "resident_step.cu": {
        "tpusim_resident_step": [
            # the pods' rows, their width, the pod counter t1
            _P, _I, _P,
            # the statics (kernels/resident_step.py STATICS_READ order)
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            # the carry (CARRY_WRITTEN order), rr last
            _P, _P, _P, _P, _P, _P, _P, _P, _P,
            # choices, counts, advanced
            _P, _P, _P,
            # nodes, scalar resources, reason bits; the six score weights
            _I, _I, _I, _I, _I, _I, _I, _I, _I,
            # the geometry: cluster, threads, dynamic shared bytes; stream
            _I, _I, _I, _P],
        # cluster, threads, dynamic shared bytes
        "tpusim_resident_step_prepare": [_I, _I, _I],
    },
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpusim_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def _library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def _compile_cmd(source: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, source)]


def build_all(verbose: bool = False) -> None:
    """Compile every source that has no library yet, one nvcc per source,
    all started together."""
    build(SOURCES, verbose)


def build(sources, verbose: bool = False) -> None:
    """Compile each of `sources` that has no library yet, one nvcc per
    source, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for source in sources:
        out = _library_path(source)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = _compile_cmd(source, tmp)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(log, end="")
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be (that
    source alone: a first use compiles only what it loads)."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is not None:
            return lib
        path = _library_path(source)
        if not os.path.exists(path):
            build([source])
        lib = ctypes.CDLL(path)
        for name, argtypes in SOURCES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[source] = lib
        return lib
