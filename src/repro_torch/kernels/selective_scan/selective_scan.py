"""CUDA kernel for the Mamba-1 selective scan, built and bound at first use.

Replaces the Pallas TPU kernel ``repro/kernels/selective_scan/
selective_scan.py::selective_scan``.  The source is
``csrc/selective_scan.cu`` (its header note gives the design and the bound
on an H100): one thread per channel with its states in registers, B and C
read as shared-memory broadcasts, y summed in registers, and, where B * Di
alone cannot fill the card, chunks of the sequence scanned in parallel
with a carry pass (`chunk_len` is the rule).  ``nvcc`` compiles it for
``sm_90a`` into a shared library under the repository's ``build/kernels/``
the first time a CUDA tensor reaches `selective_scan`
(``kernels/_nvcc.py``); the library is loaded with ``ctypes``.  Nothing is
compiled at module import.

`LAUNCHES` counts the wrapper's calls that launched the kernel (one per
call: the local and final passes of a chunked run count as one).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 32       # states per channel: 8 per thread, at most 4 threads
# the chunk rule: one pass when B * Di * threads per channel reaches
# FILL_THREADS; else chunks of a multiple of STEP steps, enough of them for
# about TARGET_THREADS threads (selective_scan.cu's header note)
FILL_THREADS = 32768
TARGET_THREADS = 65536
STEP = 16

# wrapper launches; read by chip_smoke.py to show the main path ran here
LAUNCHES = 0
_count_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    lib.selective_scan_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
    lib.selective_scan_launch.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p


def build() -> Path:
    """Compile csrc/selective_scan.cu (once per source and flags) and
    return the library's path."""
    return _nvcc.build(SOURCE, "selective_scan")


def load() -> ctypes.CDLL:
    """Build if needed and bind the C entry points (idempotent)."""
    return _nvcc.load(SOURCE, "selective_scan", _bind)


def chunk_len(bsz: int, s: int, di: int, n: int) -> int:
    """Steps per sequence chunk for a scan of shape (bsz, s, di, n): all of
    s (one pass) when bsz * di channels fill the card, else a multiple of
    STEP that cuts s into about TARGET_THREADS / threads chunks."""
    threads = bsz * di * (1 if n <= 8 else 2 if n <= 16 else 4)
    if threads >= FILL_THREADS:
        return s
    chunks = -(-TARGET_THREADS // threads)
    length = -(-s // chunks)
    return min(s, -(-length // STEP) * STEP)


def _check(x, dt, a, b_ssm, c_ssm, d_skip, h0) -> None:
    named = [("x", x), ("dt", dt), ("a", a), ("b_ssm", b_ssm),
             ("c_ssm", c_ssm), ("d_skip", d_skip)]
    if h0 is not None:
        named.append(("h0", h0))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"selective_scan: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != x.device:
            raise ValueError(f"selective_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"selective_scan: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t in named[1:]:
        want = x.dtype if name in ("b_ssm", "c_ssm") else torch.float32
        if t.dtype != want:
            raise TypeError(f"selective_scan: {name} must be {want} (x is "
                            f"{x.dtype}), got {t.dtype}")
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"selective_scan: need x (B,S,Di) and a (Di,N), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    bsz, s, di = x.shape
    n = a.shape[1]
    want = {"dt": (bsz, s, di), "a": (di, n), "b_ssm": (bsz, s, n),
            "c_ssm": (bsz, s, n), "d_skip": (di,), "h0": (bsz, di, n)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan: {name} is {tuple(t.shape)}, "
                             f"need {want[name]}")
    if not (1 <= n <= MAX_STATE and bsz >= 1 and s >= 1 and di >= 1):
        raise ValueError(f"selective_scan: need 1 <= N <= {MAX_STATE} and "
                         f"B, S, Di >= 1; got N={n}, B={bsz}, S={s}, Di={di}")
    if bsz > 65535 or max(s, di) >= 2 ** 31:
        raise ValueError("selective_scan: need B <= 65535 (the grid's y) "
                         "and S, Di below 2**31")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                   d_skip: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """x (B,S,Di) and b_ssm, c_ssm (B,S,N) of one dtype (float32 or
    bfloat16); dt (B,S,Di), a (Di,N), d_skip (Di,) and h0 (B,Di,N) or None
    in float32; all contiguous on one CUDA device.  Returns y (B,S,Di) in
    x's dtype and h_end (B,Di,N) in float32."""
    global LAUNCHES
    _check(x, dt, a, b_ssm, c_ssm, d_skip, h0)
    lib = load()
    bsz, s, di = x.shape
    n = a.shape[1]
    # the kernel copies B and C rows in 16-byte chunks from 16-byte
    # boundaries at or after the tensor's start
    b_ssm, c_ssm = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (b_ssm, c_ssm))
    chunk = chunk_len(bsz, s, di, n)
    chunks = -(-s // chunk)
    y = torch.empty_like(x)
    h_end = torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty((2, max(chunks - 1, 0), bsz, di, n),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_ssm.data_ptr(),
            c_ssm.data_ptr(), d_skip.data_ptr(),
            None if h0 is None else h0.data_ptr(), bsz, s, di, n, chunk,
            int(x.dtype == torch.bfloat16), scratch[0].data_ptr(),
            scratch[1].data_ptr(), y.data_ptr(), h_end.data_ptr(), stream)
    if err != 0:
        msg = lib.selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective_scan: launch failed with CUDA error "
                           f"{err} ({msg})")
    with _count_lock:
        LAUNCHES += 1
    return y, h_end
