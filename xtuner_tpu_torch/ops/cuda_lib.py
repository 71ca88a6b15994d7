"""Build and load the port's hand-written CUDA kernels.

Every `*.cu` under `xtuner_tpu_torch/csrc/` is compiled with `nvcc` for
Hopper (`sm_90a`), one `nvcc` per source, all started together, and linked
into one shared library with a plain C interface, loaded with `ctypes`. No
PyTorch header is included, so a build takes seconds, not minutes. The build runs at first use into `xtuner_tpu_torch/_build/`
(git-ignored), under a name that carries the sources' hash, so an edited
source rebuilds and an unchanged one is loaded as it is. The compiler's
`-Xptxas -v` report (registers, shared memory, spills per kernel) is kept
beside the library as `<name>.log`.

Nothing here runs at import: the CPU tests import every module, and this
machine's kernels exist only where `nvcc` and a card do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # q, k, v, segment_ids, tile table scratch (B, Lp / 64, 4), out, lse, B,
    # L, Hq, Hkv, D, Dv, scale, window (0: full), causal (0: bidirectional),
    # max_logit bound (device f32 or null), max-free launch count (device
    # int32 or null), tiles walked and full (device int64[2] or null), stream
    "xt_flash_fwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                          _P, _P, _P, _P],
    # the dynamic shared memory of one forward CTA (bytes): D, Dv
    "xt_flash_fwd_smem_bytes": [_I, _I],
    # q, k, v, do, lse, delta, segment_ids, tile table, dq (the f32
    # accumulator at D 128, bf16 dq at 192 and 64), dk, dv, B, L, Lp, Hq,
    # Hkv, D, Dv, scale, two_pass, window (0: full), causal, stream
    "xt_flash_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # the dynamic shared memory of one backward CTA (bytes): kernel (0 the
    # one pass, 1 dq, 2 dk/dv), D, Dv
    "xt_flash_bwd_smem_bytes": [_I, _I, _I],
    # q, pool_k, pool_v, block_table, seq_lens, sinks (f32 or null), out,
    # split workspace (f32), merge tickets (int32, zero), B, C, Hq, Hkv, D,
    # L, NB, BS, MB, layer, splits, window (0: full), scale, stream
    "xt_paged_decode_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # the dynamic shared memory of one paged decode CTA (bytes): block
    # size, head dim
    "xt_paged_decode_smem_bytes": [_I, _I],
    # x, w, group_sizes, out, M, C, E, K, N, transpose_rhs, walked counts
    # (device int64[3] or null), stream
    "xt_grouped_gemm_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # x, dy, group_sizes, dw, M, E, K, N, walked counts, stream
    "xt_grouped_gemm_dw_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # the dynamic shared memory of one grouped CTA (bytes): mode (0 nn, 1 nt,
    # 2 dw), block width (128 or 256)
    "xt_grouped_gemm_smem_bytes": [_I, _I],
    # x, w_gu, w_dn, group_sizes, out, gu, hidden slots (bf16 scratch), slots,
    # M, E, H, F, walked counts (device int64[3] or null), stream
    "xt_fused_moe_mlp_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # the dynamic shared memory of one fused-MLP CTA (bytes)
    "xt_fused_moe_mlp_smem_bytes": [],
    # h, w, labels, per-tile statistics scratch (f32), lse, label_logit, N,
    # V, H, stream
    "xt_ce_fwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # one row chunk: h, w, labels, lse, g_lse, g_lab, c out, rows, V, H,
    # V_pad, stream
    "xt_ce_coeff_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # f32 accumulator, bf16 out, count, stream
    "xt_ce_round_bf16": [_P, _P, _L, _P],
    # the fused-CE backward's products (one group, no counts): x, w, rows
    # (device int32), out, M, x row stride, K, N, stream
    "xt_gemm_nn_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, dy, rows, dw (f32), M, x row stride, K, N, accumulate, stream
    "xt_gemm_dw_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # xq, sx, wt (N, K), sw, out, M, K, N, a type, b type (0 e4m3, 1 e5m2),
    # out f32 (0: bf16), stream
    "xt_fp8_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # xq, sx, wt (E, N, K), sw, group_sizes, out, walked counts (device
    # int64[3] or null), M, K, N, E, a type, b type, out f32, stream
    "xt_fp8_grouped_gemm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # xt (Mp/128, K, 128), sx, yt (Mp/128, N, 128), sy, group_sizes, dw,
    # walked counts, Mp, K, N, E, x type, y type, stream
    "xt_fp8_grouped_dw": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # the dynamic shared memory of one fp8 grouped CTA (bytes): out f32 (0:
    # #12 in bf16; 1: #12 in f32, and #13)
    "xt_fp8_grouped_smem_bytes": [_I],
    # q, k, v, block_idx, segment_ids, tile table scratch (B, Lp / 64, 4),
    # out, lse, mass, B, L, Hq, Hkv, D, Dv, block, S, scale, stream
    "xt_block_sparse_fwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, block_idx, segment_ids, out, do, lse, then scratch: delta (B,
    # Hq, L) f32, the tile table, the inverse count and list; dq, dk, dv, B,
    # L, Hq, Hkv, D, Dv, block, S, scale, stream
    "xt_block_sparse_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # the dynamic shared memory of one block-sparse CTA (bytes): kernel (0
    # forward, 1 dq, 2 dk/dv), D, Dv
    "xt_block_sparse_smem_bytes": [_I, _I, _I],
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libxtuner_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if the current sources have no library yet.
    Returns (library path, seconds spent compiling; 0.0 if it existed)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-8000:]}")
    tmp = so.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-8000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and synchronize() would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
