"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its own
shared library for ``sm_90a``, then loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries go to ``_build/`` next to this
file (ignored by git), named by a digest of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU path never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build_all", "load", "BUILD_DIR", "SOURCES", "PTXAS_INFO"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

SOURCES = {"mix_aggregate": "mix_aggregate.cu", "stc_rows": "stc_rows.cu",
           "stc_compress": "stc_compress.cu",
           "dol_bid_scores": "dol_bid_scores.cu",
           "bid_value_fuse": "bid_value_fuse.cu", "quant": "quant.cu",
           "flash_attention": "flash_attention.cu",
           "ssm_scan": "ssm_scan.cu", "ssd_scan": "ssd_scan.cu",
           "launch_floor": "launch_floor.cu"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points of each library: name -> argument types (pointers and the
# stream as void*, sizes as int or long long, scalars as float); every
# launching entry point returns cudaError_t (repro_ssd_scan_smem_bytes
# returns bytes, repro_stc_reduce_max_blocks a block count,
# repro_stc_fused_max_n an element count, repro_stc_rows_max_chunks a
# chunk count and repro_quant_roundtrip_max_entries / _max_leaves the
# roundtrip's table capacity).
_SIGNATURES = {
    "mix_aggregate": {
        "repro_mix_aggregate_f32": [_P, _P, _P, _I, _I, _I, _P]},
    "stc_rows": {
        "repro_stc_rows_reduce_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "repro_stc_rows_apply_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _P],
        "repro_stc_rows_max_chunks": []},
    "stc_compress": {
        "repro_stc_reduce_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _P],
        "repro_stc_apply_f32": [_P, _P, _P, _P, _P, _I, _P, _L, _P],
        "repro_stc_fused_f32": [_P, _P, _P, _P, _P, _I, _I, _P],
        "repro_stc_rows_fused_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _P],
        "repro_stc_reduce_max_blocks": [], "repro_stc_fused_max_n": []},
    "dol_bid_scores": {
        "repro_dol_bid_scores_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "bid_value_fuse": {
        "repro_bid_value_fuse_f32": [_P, _P, _F, _P, _I, _I, _P]},
    "quant": {
        "repro_quant_pack_f32": [_P, _P, _P, _I, _I, _P],
        "repro_quant_unpack_f32": [_P, _P, _P, _I, _I, _P],
        "repro_quant_roundtrip_f32": [_P, _P, _P, _I, _I, _P, _P, _P],
        "repro_quant_roundtrip_max_entries": [],
        "repro_quant_roundtrip_max_leaves": []},
    "flash_attention": {
        "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _P]},
    "ssm_scan": {
        "repro_ssm_scan_f32": [_P, _P, _P, _I, _I, _I, _P]},
    "ssd_scan": {
        "repro_ssd_scan_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _P],
        "repro_ssd_scan_smem_bytes": [_I, _I, _I]},
    "launch_floor": {"repro_launch_floor": [_P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each library built here.
PTXAS_INFO: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels can only be "
                           "built on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> float:
    """Compile every missing library in parallel; return the seconds spent."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        PTXAS_INFO[n] = out
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
