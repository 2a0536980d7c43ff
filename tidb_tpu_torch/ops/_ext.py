"""Build and bind the CUDA kernels of ops/csrc.

Each `.cu` source compiles with `nvcc` for `sm_90a` into a shared library
with a plain C interface, loaded with ctypes: no PyTorch headers, so a
build takes seconds, and all sources compile in parallel. Libraries go to
`build/tidb_tpu_torch/` beside the package (listed in .gitignore), named
by a hash of their sources, so an unchanged source is not rebuilt.

No `--use_fast_math`: f64 division must stay IEEE; and `-fmad=false`
(below), so that f64 planes computed by a kernel are bit-identical to
the plain versions'.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from tidb_tpu_torch import errors

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "tidb_tpu_torch")

SOURCES = ("expr_vm", "scalar_agg", "seg_agg_onehot", "seg_agg_sorted",
           "rank_groups", "distinct_runs", "topk_select", "seg_states_ragged",
           "combine_partials", "join_build", "join_probe", "dict_remap",
           "slot_filter", "slot_agg", "slot_topn", "sort_perm", "window_scan",
           "delta_merge", "shard_topk", "key_partition", "radix_sort")
# -fmad=false: no multiply-add contraction, so every f64 a * b + c rounds
# twice exactly as the plain versions (and the reference) round it
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint
# C signature of every exported function: (argtypes, restype)
SIGNATURES = {
    "expr_vm": {
        "expr_vm_launch": ([_L, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P], _I),
        "expr_vm_ragged_tile": ([], _I),
        "expr_vm_ragged_launch": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P], _I),
    },
    "scalar_agg": {
        "scalar_agg_grid": ([], _I),
        "scalar_agg_launch": ([_L, _P, _I, _P, _P, _P, _P, _P, _I, _P], _I),
    },
    "seg_agg_onehot": {
        "seg_onehot_blocks": ([_L], _I),
        "seg_onehot_launch": ([_L, _P, _P, _I, _I, _P, _P, _P, _P], _I),
    },
    "seg_agg_sorted": {
        "seg_sorted_pieces_count": ([_L], _I),
        "seg_sorted_launch": ([_L, _P, _P, _P, _L, _I, _P, _P, _P, _P], _I),
        "seg_agg_block_limit": ([], _L),
        "seg_agg_block_grid": ([_I, _L], _I),
        "seg_agg_block_launch": ([_I, _I, _P, _I, _P, _P, _I, _I, _P, _I, _P,
                                  _I, _I, _L, _P, _P, _P], _I),
    },
    "rank_groups": {
        "rank_groups_blocks": ([_L], _L),
        "rank_groups_launch": ([_L, _P, _P, _I, _P, _L, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P], _I),
    },
    "distinct_runs": {
        "distinct_runs_launch": ([_L, _P, _P, _P, _P, _P, _P], _I),
        "distinct_runs_words_launch": ([_L, _P, _P, _I, _P, _P], _I),
    },
    "topk_select": {
        "topk_grid": ([_I, _I, _I], _I),
        "topk_level_launch": ([_I, _I, _I, _I, _I, _L, _P, _P, _P, _I, _I,
                               _P, _P, _I, _I, _P, _L, _L, _P, _I, _I, _P,
                               _P], _I),
    },
    "seg_states_ragged": {
        "seg_states_pieces_count": ([_L], _I),
        "seg_states_block_limit": ([], _L),
        "seg_states_block_grid": ([_I, _I, _L], _I),
        "seg_states_block_launch": ([_I, _I, _I, _I, _P, _I, _I, _P, _I, _I,
                                     _I, _L, _P, _P, _P], _I),
        "seg_states_window_launch": ([_I, _I, _I, _P, _I, _I, _I, _P, _I,
                                      _I, _I, _L, _P, _P, _P], _I),
        "seg_states_keys_launch": ([_P, _I, _I, _I, _L, _P, _P, _P], _I),
        "seg_states_sorted_launch": ([_L, _P, _P, _P, _I, _I, _L, _I, _P,
                                      _P, _P], _I),
    },
    "combine_partials": {
        "combine_partials_launch": ([_I, _I, _P, _P, _P, _L, _P], _I),
    },
    "join_build": {
        "join_build_blocks": ([_L], _L),
        "join_build_launch": ([_L, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                               _P, _P], _I),
    },
    "join_probe": {
        "join_probe_blocks": ([_L], _L),
        "join_probe_count_launch": ([_L, _P, _P, _I, _P, _L, _P, _P, _P, _P,
                                     _P, _P], _I),
        "join_probe_count_seg_launch": ([_L, _P, _P, _I, _P, _L, _P, _P, _I,
                                         _P, _P, _P, _P, _P, _P], _I),
        "join_probe_expand_launch": ([_L, _L, _P, _P, _P, _P, _I, _P, _P],
                                     _I),
    },
    "dict_remap": {
        "dict_remap_launch": ([_L, _I, _P, _P, _P, _P], _I),
    },
    "slot_filter": {
        "slot_filter_launch": ([_L, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P,
                                _P, _I, _P, _P, _P], _I),
    },
    "slot_agg": {
        "slot_agg_blocks": ([_L], _I),
        "slot_agg_launch": ([_L, _I, _I, _P, _I, _U, _P, _I, _I, _P, _P, _I,
                             _P, _I, _P, _P, _P, _P], _I),
    },
    "slot_topn": {
        "slot_topn_grid": ([_I, _I, _I], _I),
        "slot_topn_launch": ([_I, _P, _I, _I, _L, _P, _P, _P, _P, _L, _P,
                              _P], _I),
    },
    "sort_perm": {
        "sort_perm_summary_launch": ([_L, _I, _P, _P, _P, _P, _P], _I),
        "sort_perm_pack_launch": ([_L, _I, _P, _P, _P, _P, _P, _P, _P], _I),
    },
    "window_scan": {
        "window_scan_blocks": ([_L], _L),
        "window_scan_launch": ([_L, _I, _P, _P, _P, _P, _P, _P, _P], _I),
        "window_finish_launch": ([_L, _I, _P, _P, _P, _P, _P, _P, _P], _I),
    },
    "delta_merge": {
        "delta_merge_blocks": ([_L], _L),
        "delta_merge_launch": ([_L, _P, _P, _P, _L, _P, _L, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _P], _I),
    },
    "key_partition": {
        "key_partition_blocks": ([_L], _L),
        "key_partition_launch": ([_L, _P, _P, _I, _I, _P, _P, _P, _P, _P],
                                 _I),
    },
    "radix_sort": {
        "radix_scratch_ints": ([_L], _L),
        "radix_pass_launch": ([_L, _I, _P, _I, _P, _P, _P, _P, _P, _P],
                              _I),
    },
    "shard_topk": {
        "shard_topk_grid": ([_I, _I, _I], _I),
        "shard_topk_level_launch": ([_I, _I, _I, _I, _I, _I, _L, _P, _P, _P,
                                     _I, _I, _P, _P, _I, _I, _P, _P, _P, _L,
                                     _L, _P, _I, _I, _P, _P], _I),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}     # source name -> nvcc's output (ptxas -v)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise errors.DeviceError("nvcc not found: the CUDA kernels cannot build")


def _source_hash(name: str) -> str:
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash(name)}.so")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no current library, all at once, and
    load them. Raises DeviceError with nvcc's output on a failed build."""
    with _lock:
        missing = [n for n in SOURCES if n not in _libs]
        if not missing:
            return dict(_libs)
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in missing:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise errors.DeviceError("nvcc failed:\n" + "\n".join(failed))
        for name in missing:
            lib = ctypes.CDLL(_lib_path(name))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return dict(_libs)


def lib(name: str) -> ctypes.CDLL:
    libs = _libs if name in _libs else build_all()
    return libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a launch the runtime refused (the kernel never ran)."""
    if rc != 0:
        raise errors.DeviceError(f"{what} launch failed with CUDA error {rc}")
