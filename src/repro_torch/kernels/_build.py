"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. Libraries go to ``build/kernels/``
at the repository root, named by a hash of the source, of every shared
header (``csrc/*.cuh``: ``common.cuh``, ``mma.cuh``, ``flash_tile.cuh``,
``paged_split.cuh``, ``decode_tc.cuh``) and of the flags, so a
changed source is rebuilt and an unchanged one is reused. Nothing is
built when a module is imported: the first launch of a kernel builds
its library, and ``build_all`` builds every library at once, one
``nvcc`` process per source, all started together.

Every C entry point returns ``cudaGetLastError()`` (or the error of the
``cudaFuncSetAttribute`` call before the launch); ``check`` raises when
it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mas_attention", "flash_attention", "decode_attention",
           "paged_decode_attention", "paged_prefill_attention",
           "paged_verify_attention", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signatures of the entry points, by library.
SIGNATURES = {
    "mas_attention": {
        # q, k, v, o, bhq, nq, nkv, E, group, blk_q, causal, kv_len,
        # sm_scale, stream
        "mas_resident_fp32_launch": [P, P, P, P] + [I] * 8 + [F, P],
        "mas_resident_bf16_launch": [P, P, P, P] + [I] * 8 + [F, P],
        "mas_streamed_fp32_launch": [P, P, P, P] + [I] * 8 + [F, P],
        "mas_streamed_bf16_launch": [P, P, P, P] + [I] * 8 + [F, P],
    },
    "flash_attention": {
        # q, k, v, o, bhq, nq, nkv, E, group, blk_q, causal, window,
        # q_offset, kv_len, sm_scale, stream
        "flash_attention_fp32_launch": [P, P, P, P] + [I] * 10 + [F, P],
        # the same without blk_q (the bf16 form's block is its own)
        "flash_attention_bf16_launch": [P, P, P, P] + [I] * 9 + [F, P],
    },
    "decode_attention": {
        # q, k, v, kv_lens, o, m_part, l_part, acc_part, bh, G, s_len, E,
        # n_split, tiles_per_split, sm_scale, stream
        "decode_bf16_launch": [P] * 8 + [I] * 6 + [F, P],
        "decode_fp32_launch": [P] * 8 + [I] * 6 + [F, P],
        # the same with k_scale, v_scale after v, and the query's dtype
        # before the stream
        "decode_int8_launch": [P] * 10 + [I] * 6 + [F, I, P],
    },
    "paged_decode_attention": {
        # q, k_pages, v_pages, table, kv_lens, o, m_part, l_part, acc_part,
        # B, Hkv, G, n_pages, page_size, max_pages, E, n_split,
        # tiles_per_split, sm_scale, stream
        "paged_decode_bf16_launch": [P] * 9 + [I] * 9 + [F, P],
        "paged_decode_fp32_launch": [P] * 9 + [I] * 9 + [F, P],
        # the same with k_scales, v_scales after v_pages, and the query's
        # dtype before the stream
        "paged_decode_int8_launch": [P] * 11 + [I] * 9 + [F, I, P],
    },
    "paged_prefill_attention": {
        # q, k_pages, v_pages, k_scales, v_scales, table, span (q_offset,
        # kv_len on the device), o, hq, nq, E, group, blk_q, n_pages,
        # page_size, max_pages, sm_scale, quantized, stream
        "paged_prefill_fp32_launch": [P] * 8 + [I] * 8 + [F, I, P],
        # the same without blk_q (the bf16 form's block is its own)
        "paged_prefill_bf16_launch": [P] * 8 + [I] * 7 + [F, I, P],
    },
    "paged_verify_attention": {
        # q, k_pages, v_pages, table, kv_lens, q_starts, o, m_part, l_part,
        # acc_part, B, Hkv, R, G, n_pages, page_size, max_pages, E, n_split,
        # tiles_per_split, sm_scale, stream
        "paged_verify_bf16_launch": [P] * 10 + [I] * 10 + [F, P],
        "paged_verify_fp32_launch": [P] * 10 + [I] * 10 + [F, P],
        # the same with k_scales, v_scales after v_pages, and the query's
        # dtype before the stream
        "paged_verify_int8_launch": [P] * 12 + [I] * 10 + [F, I, P],
    },
    "ssd_scan": {
        # x, a, b, c, y, states, cells, Q, N, P, stream
        "ssd_intra_chunk_bf16_launch": [P] * 6 + [I] * 4 + [P],
        "ssd_intra_chunk_fp32_launch": [P] * 6 + [I] * 4 + [P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = job
    rc = proc.wait()
    log = out.with_suffix(".log")
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed ({rc}) for {out.name}:\n{log.read_text()[-4000:]}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> float:
    """Build every library not built yet, one ``nvcc`` each, in parallel.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = [job for job in (_start(n) for n in names) if job is not None]
    try:
        for job in jobs:
            _finish(job)
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) of the
    last build of ``name``."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """The machine code of the built library of ``name``, as ``cuobjdump
    -sass`` lists it (from the toolkit beside ``nvcc``)."""
    tool = Path(nvcc()).resolve().with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(_library_path(name))],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return out.stdout


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> int | None:
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    """0 for fp32, 1 for bf16: the storage types the kernels take."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
