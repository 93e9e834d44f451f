"""Build and bind the hand-written kernels of ``csrc/``.

The CUDA sources compile with ``nvcc`` for ``sm_90a``, one process per
source started together, and link into a shared library with a plain C
interface, at first use; it loads with ctypes. The library's
name carries a hash of its sources and command, so an edited source builds
anew; concurrent processes build under a file lock and publish the result
with an atomic rename. ``host_library()`` builds the same per-stream scans
with g++ for the CPU tests.

Every launch goes through ``launch()``, which raises on a non-zero
``cudaGetLastError()`` and counts the launch per entry point in
``launches``, so that a run can show which kernels it went through, and
keeps the sub-streams per column of each split launch in ``splits``; the
library call is the span ``ac.launch`` (utils/profiling.py), and a build
the span ``ac.build``.
``launch_split()`` asks an entry point's launcher for the P it would take,
without launching.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

from ..utils import profiling

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

_HEADERS = ("ac_scan.cuh",)
_CUDA_SOURCES = ("dense_scan.cu", "stepped_scan.cu", "sparse_scan.cu",
                 "mxu_scan.cu", "assoc_scan.cu")
_HOST_SOURCES = ("ac_scan_host.cpp",)
ENTRY_POINTS = ("ac_dense_count", "ac_dense_states", "ac_stepped_count",
                "ac_stepped_emit", "ac_stepped_count_many",
                "ac_dense_count_many", "ac_dense_states_tm",
                "ac_sparse_count",
                "ac_sparse_count_stepped", "ac_dense_hits", "ac_window_hits",
                "ac_stepped_count_2t", "ac_mxu_count", "ac_hybrid_count",
                "ac_assoc_scan")

# Launches per entry point since the last reset_launches(), and per
# "entry/form" where a wrapper names the input form it launched on (K7, K8,
# K10: index list or elided windows; K8-K11: ids or raw; K9, K10: the
# count_many batch; K2: "seq", one thread); only launch() adds to them.
launches: Dict[str, int] = dict.fromkeys(ENTRY_POINTS, 0)
form_launches: Dict[str, int] = {}
# The split launches (K1-K6, K7 dense, K8, K9, K11) run each column as P
# sub-streams; the P of each one's last launch, by entry point.
SPLIT_ENTRIES = ("ac_dense_count", "ac_dense_states", "ac_stepped_count",
                 "ac_stepped_emit", "ac_stepped_count_many",
                 "ac_dense_count_many", "ac_dense_states_tm",
                 "ac_sparse_count", "ac_dense_hits", "ac_window_hits",
                 "ac_stepped_count_2t", "ac_hybrid_count")
# Entry points whose launcher also answers ``<name>_split``: the P it
# would take for a launch's fields, without launching (K8, whose two
# passes take one P; K7 dense).
PICK_ENTRIES = ("ac_sparse_count", "ac_dense_hits", "ac_window_hits")
MAX_SPLIT = 32
splits: Dict[str, int] = {}
# The 1-char stream forms (K1, K2, K7 dense, K8), whose launcher stages
# the tables on the SM where they fit; the shared-memory bytes they took at
# each one's last launch, by entry point (0: read from device memory).
DENSE_ENTRIES = ("ac_dense_count", "ac_dense_states", "ac_sparse_count",
                 "ac_dense_hits", "ac_window_hits")
dense_tables: Dict[str, int] = {}
# Seconds and compiler output of the last build this process ran (None
# when the library was already built).
last_build: Dict[str, object] = {"seconds": None, "log": ""}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class AcScanArgs(ctypes.Structure):
    """Mirror of ``struct AcScanArgs`` in csrc/ac_scan.cuh."""
    _fields_ = [
        ("table", ctypes.c_void_p), ("nb_out", ctypes.c_void_p),
        ("ext", ctypes.c_void_p), ("lut", ctypes.c_void_p),
        ("head_ids", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("n_hits", ctypes.c_void_p), ("n_live", ctypes.c_void_p),
        ("L", ctypes.c_int64), ("Vk", ctypes.c_int64),
        ("B", ctypes.c_int32), ("V", ctypes.c_int32),
        ("halo", ctypes.c_int32), ("ext_u8", ctypes.c_int32),
        ("n_lut", ctypes.c_int32), ("k", ctypes.c_int32),
        ("count_bits", ctypes.c_int32),
        ("doc_len", ctypes.c_int64), ("n_docs", ctypes.c_int32),
        ("idx", ctypes.c_void_p),
        ("col_stride", ctypes.c_int64), ("row_stride", ctypes.c_int64),
        ("gather", ctypes.c_int32),
        ("hit_pos", ctypes.c_void_p), ("hit_state", ctypes.c_void_p),
        ("hit_off", ctypes.c_void_p),
        ("table2", ctypes.c_void_p), ("planes_t", ctypes.c_void_p),
        ("S_pad", ctypes.c_int32), ("n_planes", ctypes.c_int32),
        ("count_bits_m", ctypes.c_int32), ("B1", ctypes.c_int32),
        ("layout", ctypes.c_int32),
        ("compose", ctypes.c_void_p), ("starts", ctypes.c_void_p),
        ("n_states", ctypes.c_int32), ("tile", ctypes.c_int32),
        ("warm_steps", ctypes.c_int32), ("split", ctypes.c_int32),
        ("global_table", ctypes.c_int32),
    ]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    form_launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin); the CUDA kernels cannot be "
                           "built on this machine")
    return path


def build_library(name: str, paths, stages, headers=()) -> str:
    """Compile the source files ``paths`` into BUILD_DIR at most once
    across processes; return the library's path. ``stages(out_path,
    paths)`` gives a list of stages, each a list of commands that run in
    parallel; the name hashes the sources, ``headers`` and the commands."""
    digest = hashlib.sha1()
    for p in sorted(list(paths) + list(headers)):
        with open(p, "rb") as f:
            digest.update(f.read())
    for stage in stages("out.so", paths):
        for cmd in stage:
            digest.update(" ".join(cmd[1:]).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock, \
            profiling.span("ac.build"):
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        log = []
        try:
            for stage in stages(tmp, paths):
                procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
                         for cmd in stage]
                log += [p.communicate()[0] for p in procs]
                if any(p.returncode for p in procs):
                    raise RuntimeError(f"building {name} failed:\n"
                                       + "".join(log))
            os.replace(tmp, so)
        finally:
            for f in os.listdir(BUILD_DIR):
                if f.startswith(os.path.basename(tmp)):
                    os.remove(os.path.join(BUILD_DIR, f))
        last_build["seconds"] = time.perf_counter() - t0
        last_build["log"] = "".join(log)
    return so


def _csrc(names):
    return [os.path.join(CSRC_DIR, n) for n in names]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(AcScanArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in PICK_ENTRIES:
        fn = getattr(lib, f"{name}_split")
        fn.argtypes = [ctypes.POINTER(AcScanArgs),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.ac_error_string.argtypes = [ctypes.c_int]
    lib.ac_error_string.restype = ctypes.c_char_p
    lib.ac_last_split.argtypes = []
    lib.ac_last_split.restype = ctypes.c_int
    lib.ac_last_dense_table.argtypes = []
    lib.ac_last_dense_table.restype = ctypes.c_int64
    lib.ac_stepped_split.argtypes = [ctypes.c_int64] * 4 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.ac_stepped_split.restype = ctypes.c_int
    return lib


def pick_split(lib: ctypes.CDLL, n_cols: int, n_body: int, halo_steps: int,
               warm_steps: int, slots, wide_split: int = MAX_SPLIT) -> int:
    """The P a stepped launch picks (``ac_pick_split`` in
    csrc/ac_scan.cuh) for ``n_cols`` columns of ``n_body`` body grams,
    given ``slots[i]``, the threads the card holds at once at P = 2**i;
    a P above ``wide_split`` only where its launch fits one wave (K5's and
    K9's batch launches: 8)."""
    arr = (ctypes.c_int64 * 6)(*slots)
    return lib.ac_stepped_split(n_cols, n_body, halo_steps, warm_steps, arr,
                                wide_split)


def check_split(split: int) -> None:
    """A forced split is a power of two in [1, MAX_SPLIT], or 0 (the
    launcher picks)."""
    if split and not (0 < split <= MAX_SPLIT and split & (split - 1) == 0):
        raise ValueError(f"split={split} is not 0 or a power of two up to "
                         f"{MAX_SPLIT}")


def _load(kind: str, build) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(kind)
        if lib is None:
            lib = _libs[kind] = _bind(ctypes.CDLL(build()))
        return lib


def cuda_library() -> ctypes.CDLL:
    """The sm_90a kernels, built with nvcc at first use: one nvcc per
    source, all at once, then one link."""
    def stages(out, paths):
        nvcc = _nvcc()
        arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
        objs = [f"{out}.{i}.o" for i in range(len(paths))]
        return [[[nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v", "-I", CSRC_DIR, "-c", "-o", obj, src]
                 for obj, src in zip(objs, paths)],
                [[nvcc, *arch, "-shared", "-o", out, *objs]]]
    return _load("cuda", lambda: build_library(
        "ac_kernels", _csrc(_CUDA_SOURCES), stages, _csrc(_HEADERS)))


def host_library() -> ctypes.CDLL:
    """The same per-stream scans built with g++ (csrc/ac_scan_host.cpp),
    one stream after another: what the CPU tests run in place of the
    card."""
    def stages(out, paths):
        return [[["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                  "-I", CSRC_DIR, "-o", out, *paths]]]
    return _load("host", lambda: build_library(
        "ac_scan_host", _csrc(_HOST_SOURCES), stages, _csrc(_HEADERS)))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def scan_args(**fields) -> AcScanArgs:
    """AcScanArgs from tensors (pointers; None for a null pointer) and
    ints. ``warm_steps`` is -1 unless given, so that a split launch (K1-K6,
    K7 dense, K8, K9, K11) without it fails rather than count wrong."""
    args = AcScanArgs(warm_steps=-1)
    for key, val in fields.items():
        setattr(args, key, _ptr(val) if isinstance(val, torch.Tensor)
                or val is None else val)
    return args


def launch(name: str, device: torch.device, form: Optional[str] = None,
           **fields) -> None:
    """Launch entry point ``name`` of the CUDA library on the current
    stream of ``device``; raise on a launch error, count the launch (and
    under ``name/form`` when a form is given)."""
    lib = cuda_library()
    args = scan_args(**fields)
    with profiling.span("ac.launch") as sp, torch.cuda.device(device):
        sp.note("entry", name)
        sp.note("form", form)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(ctypes.byref(args), stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.ac_error_string(err).decode()})")
    launches[name] += 1
    if name in SPLIT_ENTRIES:
        splits[name] = lib.ac_last_split()
    if name in DENSE_ENTRIES:
        dense_tables[name] = lib.ac_last_dense_table()
    if form is not None:
        key = f"{name}/{form}"
        form_launches[key] = form_launches.get(key, 0) + 1


def launch_split(name: str, device: torch.device, **fields) -> int:
    """The sub-streams per column that entry point ``name`` (one of
    PICK_ENTRIES) of the CUDA library takes for these fields on
    ``device``: their ``split`` where set, else its launcher's pick over
    the kernel's occupancy; nothing is launched. Raises where the launch
    would fail (no ``warm_steps``, a bad split)."""
    lib = cuda_library()
    args = scan_args(**fields)
    P = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(lib, f"{name}_split")(ctypes.byref(args),
                                             ctypes.byref(P))
    if err:
        raise RuntimeError(f"{name}_split: CUDA error {err} "
                           f"({lib.ac_error_string(err).decode()})")
    return P.value
