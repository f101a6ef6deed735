"""Build and load the port's CUDA kernels.

Each `.cu` under `magicpig_tpu_torch/csrc/` is compiled by its own `nvcc`
process, all started together, and one more `nvcc` call links the objects
into one shared library with a plain C interface, loaded with `ctypes`; no
PyTorch header is compiled, so the build takes seconds. The library lands in
`magicpig_tpu_torch/_build/` under a name keyed on a hash of the sources,
so it is rebuilt only when they change. The build runs on first use, never
at import.

`LAUNCHES` counts, per kernel form, the calls that launched a kernel; a run
can reset it and read it back to show that a path went through the kernels.
A form outside the pre-registered ones (a group size of the general tile,
"_g<G>") gets its key at its first launch.
`W4_SHAPE_LAUNCHES` splits the int4 matmul's count by weight shape. A CUDA
graph's launches count once per replay, not at capture (`CapturedLaunches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")

# The forms of each kernel at head dim 64; those of every kernel but the
# collision scan and the int4 matmul (which have no head dim) are counted
# apart at head dims 16, 32 and 128 too, as "<form>_d<d>". The group size
# is in the name only where it is not 1, 2, 4 or 8 (nor 3 at head dim 128
# or in the scan): "<form>[_d<d>]_g<G>" (`group_suffix`).
_D64_FORMS = (
    "flash_prefill",
    "flash_decode",
    "flash_decode_int8",
    "lsh_fused_decode",
    "lsh_fused_decode_int8",
    "lsh_fused_decode_poly",
    "lsh_fused_decode_none",
    "lsh_fused_decode_int8_poly",
    "lsh_fused_decode_int8_none",
    "block_rank",
    "block_rank_int4",
    "exact_scores_ranked",
    "exact_scores_ranked_int4",
    "exact_scores",
    "rescore_attend",
    "rescore_attend_int4",
    "block_attend",
    "lsh_masked_attention",
    "lsh_masked_attention_int8",
    "lsh_masked_attention_poly",
    "lsh_masked_attention_none",
    "lsh_masked_attention_int8_poly",
    "lsh_masked_attention_int8_none",
)
LAUNCHES: dict[str, int] = {
    **{name + dim: 0 for name in _D64_FORMS
       for dim in ("", "_d16", "_d32", "_d128")},
    "collision_words": 0,
    "w4_matmul": 0,
    **{"flash_prefill_bwd" + dim: 0 for dim in ("", "_d16", "_d32", "_d128")},
}
# The int4 matmul's launches by weight shape ("{kin}x{out}"): each product
# of a decode step's share of LAUNCHES["w4_matmul"].
W4_SHAPE_LAUNCHES: dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: argument types, each returning cudaGetLastError().
_SIGNATURES = {
    "mp_flash_prefill": [_P] * 7 + [_I] * 7 + [_F, _P],
    "mp_flash_prefill_bwd": [_P] * 12 + [_I] * 7 + [_F, _P],
    "mp_flash_decode": [_P] * 12 + [_I] * 6 + [_F, _P],
    "mp_lsh_fused_decode": [_P] * 16 + [_I] * 8 + [_F, _I, _P, _P],
    "mp_lsh_masked_attention": [_P] * 15 + [_I] * 8 + [_F, _I, _P, _P],
    "mp_collision_words": [_P] * 4 + [_I] * 7 + [_P],
    "mp_block_score": [_P] * 6 + [_I] * 7 + [_F, _P],
    "mp_rescore_attend": [_P] * 12 + [_I] * 9 + [_F, _P],
    "mp_block_attend": [_P] * 9 + [_I] * 9 + [_P],
    "mp_w4_matmul": [_P] * 6 + [_I] * 6 + [_P],
}

_lib: ctypes.CDLL | None = None
_build_error: RuntimeError | None = None
last_build_seconds: float | None = None
last_build_log: str = ""
# Seconds each source's nvcc took in the last build (they run at once, so
# the longest one sets the build's time).
last_source_seconds: dict[str, float] = {}


def sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libmagicpig_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile each .cu under csrc/ with its own nvcc process, all running
    at once, and link the objects into the library (skipped when the
    library for these sources and flags exists). Returns its path. The
    compiler's report (`-Xptxas -v`: registers, shared memory, spills) is
    kept in `last_build_log` and `_build/build.log`, each source's compile
    time in `last_source_seconds`. A failed build raises, and raises the
    same error again on every later call of the process without compiling
    anew."""
    global last_build_seconds, last_build_log, _build_error
    if _build_error is not None:
        raise _build_error
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs, logs = [], {}, []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            report = open(Path(tmp) / (src.stem + ".log"), "w+")
            procs[src.name] = (cmd, report, subprocess.Popen(
                cmd, stdout=report, stderr=subprocess.STDOUT))
        last_source_seconds.clear()
        while len(last_source_seconds) < len(procs):
            for name, (_, _, proc) in procs.items():
                if name not in last_source_seconds and proc.poll() is not None:
                    last_source_seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
        failed = False
        for name, (cmd, report, proc) in procs.items():
            report.seek(0)
            logs.append(" ".join(cmd) + "\n" + report.read())
            report.close()
            failed |= proc.returncode != 0
        if not failed:
            so = str(Path(tmp) / out.name)
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs.append(" ".join(cmd) + "\n" + proc.stdout)
            failed = proc.returncode != 0
        last_build_seconds = time.perf_counter() - t0
        last_build_log = "\n".join(logs)
        (BUILD_DIR / "build.log").write_text(last_build_log)
        if failed:
            _build_error = RuntimeError(f"nvcc failed:\n{last_build_log}")
            raise _build_error
        os.replace(so, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mp_error_string.argtypes = [ctypes.c_int]
        lib.mp_error_string.restype = ctypes.c_char_p
        lib.mp_set_device.argtypes = [ctypes.c_int]
        lib.mp_set_device.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = library().mp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry `entry` on `device`'s current stream (appended as the
    last argument), raise on a CUDA error, and count the launch under
    `name`. Tensor arguments are passed as device pointers."""
    lib = library()
    _check(lib.mp_set_device(device.index or 0), name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    cargs.append(torch.cuda.current_stream(device).cuda_stream)
    _check(getattr(lib, entry)(*cargs), name)
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


# The head dims of the decode-side kernels and of the prefill: every one
# that divides 128 from 16 (the JAX package's Pallas kernels take each
# divisor of 128; below 16 no preset or published model goes). Others raise
# before any launch.
HEAD_DIMS = (16, 32, 64, 128)
# Group sizes with an exact instance of every decode-side kernel at head
# dims 64 and 128, and the one at 128 only (Llama-3.2-3B: 24 query heads
# over 8; the scan has no head dim and takes it too). Every other group
# size, and every one at head dims 16 and 32, runs the kernel's general
# tile (`exact_group` in csrc/common.cuh): blocks of at most `tile` query
# heads of a kv head, ceil(G / tile) of them a kv head, each with its own
# merge ticket. The tile is a kernel family's: HEAD_TILE (16 heads: one
# mma.sync M tile in flash decode and both LSH kernels, two n8 tiles in the
# block scorer and both attends of the selected blocks: `kHeadTile`),
# GROUP_TILE (8: `kGroupTile`) for the standalone collision scan.
GROUPS = (1, 2, 4, 8)
GROUPS_D128 = (3,)
GROUP_TILE = 8
HEAD_TILE = 16


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def group_suffix(g: int, head_dim: int | None) -> str:
    """The launch counter's group part: "" for the group sizes the
    counters have always taken (1, 2, 4, 8; 3 at head dim 128 or in the
    scan), else "_g<G>"."""
    plain = g in GROUPS or (g in GROUPS_D128 and head_dim in (None, 128))
    return "" if plain else f"_g{g}"


def exact_group(g: int, head_dim: int | None) -> bool:
    """Whether group size g has an exact instance at `head_dim` (None:
    the collision scan): those `group_suffix` leaves unnamed, at head dims
    64 and 128."""
    return head_dim in (None, 64, 128) and not group_suffix(g, head_dim)


def head_blocks(g: int, head_dim: int | None, tile: int) -> int:
    """Blocks a kv head's query heads take (each with its own merge
    ticket): 1 for an exact instance, ceil(g / tile) for the general tile
    of a family whose tile is `tile` (HEAD_TILE or GROUP_TILE)."""
    return 1 if exact_group(g, head_dim) else -(-g // tile)


def check_group(name: str, hq: int, hkv: int, head_dim: int | None) -> None:
    """hq is a positive multiple of hkv, and `head_dim` (None: the
    collision scan, which has none) one of HEAD_DIMS."""
    require(hkv > 0 and hq >= hkv and hq % hkv == 0,
            f"{name}: {hq} query heads over {hkv} kv heads unsupported")
    require(head_dim is None or head_dim in HEAD_DIMS,
            f"{name}: head_dim {head_dim} not in {HEAD_DIMS}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, contiguous, 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        require(t.device == dev, f"{name}: tensors on {t.device} and {dev}")
        require(t.is_contiguous(), f"{name}: inputs must be contiguous")
        require(t.data_ptr() % 16 == 0, f"{name}: inputs must be 16-byte aligned")


# The pre-registered forms; `reset_launches` drops the others (a general
# tile's group sizes), so that a run's counts list only its own.
_REGISTERED = frozenset(LAUNCHES)


def reset_launches() -> None:
    for k in list(LAUNCHES):
        if k in _REGISTERED:
            LAUNCHES[k] = 0
        else:
            del LAUNCHES[k]
    W4_SHAPE_LAUNCHES.clear()


class CapturedLaunches:
    """The launches counted while a CUDA graph was captured. As a context
    around the capture, it takes them back out of `LAUNCHES` and
    `W4_SHAPE_LAUNCHES` on exit (a capture runs nothing); `replayed()` adds
    them once per replay, so the counts keep meaning kernels executed."""

    def __enter__(self) -> "CapturedLaunches":
        self._before = dict(LAUNCHES), dict(W4_SHAPE_LAUNCHES)
        return self

    def __exit__(self, *exc) -> None:
        launches, shapes = self._before
        self.launches = {k: n - launches.get(k, 0)
                         for k, n in LAUNCHES.items()
                         if n != launches.get(k, 0)}
        self.shapes = {k: n - shapes.get(k, 0)
                       for k, n in W4_SHAPE_LAUNCHES.items()
                       if n != shapes.get(k, 0)}
        for k in LAUNCHES:
            LAUNCHES[k] = launches.get(k, 0)
        W4_SHAPE_LAUNCHES.clear()
        W4_SHAPE_LAUNCHES.update(shapes)

    def replayed(self) -> None:
        for k, n in self.launches.items():
            LAUNCHES[k] = LAUNCHES.get(k, 0) + n
        for k, n in self.shapes.items():
            W4_SHAPE_LAUNCHES[k] = W4_SHAPE_LAUNCHES.get(k, 0) + n
