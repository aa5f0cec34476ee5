"""Fused vocab head: matmul + log-sum-exp + per-row top-k
(``captionkit.ops.head``; the kernel is ``csrc/head_topk.cu``).

``fused_head_topk(h, w, b, k=k)`` returns (vals [N, k] fp32 raw logits,
descending, equal values lowest index first; idx [N, k] int32; lse [N]
fp32) for logits = h @ w + b. On a CUDA tensor it launches the hand-written
kernel, which never writes the [N, V] logits to device memory, or raises.
On a CPU tensor it computes the same function with ``reference_head_topk``,
the plain version, which forms the full logits.

``prepad_head`` pads the head once per decode batch: the vocab axis to a
multiple of the kernel's 128-column tile, padded columns with bias
``HEAD_PAD`` (never in the top-k; exp() = 0 in the log-sum-exp).
"""

from __future__ import annotations

import ctypes

import torch

from captionkit_torch.nn.topk import topk_lowest_index

HEAD_PAD = -1e30  # head padding; not the attention mask's NEG_INF
TILE_V = 128  # the kernel's vocab tile (BN in csrc/head_topk.cu)
KMAX = 8  # the kernel's largest k


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prepad_head(w: torch.Tensor, b: torch.Tensor, *,
                compute_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(w [H, Vp] in the compute dtype, b [Vp] fp32), Vp a multiple of
    TILE_V; padded columns have weight 0 and bias HEAD_PAD."""
    H, V = w.shape
    Vp = _round_up(V, TILE_V)
    w_p = w.new_zeros((H, Vp), dtype=compute_dtype)
    w_p[:, :V] = w.to(compute_dtype)
    b_p = torch.full((Vp,), HEAD_PAD, dtype=torch.float32, device=b.device)
    b_p[:V] = b.float()
    return w_p, b_p


def reference_head_topk(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        k: int):
    """Plain version: full fp32 logits -> top-k with lowest-index ties +
    logsumexp. bf16 operands are exact in fp32, so this is the kernel's
    function up to the order of the fp32 sums."""
    logits = h.float() @ w.float() + b.float()
    vals, idx = topk_lowest_index(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=1)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ck_head_topk.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.ck_head_topk.restype = ctypes.c_int
    lib.ck_error_string.argtypes = [ctypes.c_int]
    lib.ck_error_string.restype = ctypes.c_char_p
    for name in ("ck_head_tile_width", "ck_head_kmax"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    # The scratch sizes below are computed from these two constants.
    if (lib.ck_head_tile_width(), lib.ck_head_kmax()) != (TILE_V, KMAX):
        raise RuntimeError("csrc/head_topk.cu and kernels/head.py disagree "
                           "on the vocab tile or the largest k")


def _library() -> ctypes.CDLL:
    from captionkit_torch.kernels import build

    lib = build.load("head_topk")
    _bind(lib)
    return lib


def _check_cuda_inputs(h, w, b, k):
    if not (h.is_cuda and w.device == h.device and b.device == h.device):
        raise ValueError("h, w and b must be on the same CUDA device")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA head takes bfloat16 h and w, got "
                        f"{h.dtype} and {w.dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"b must be float32, got {b.dtype}")
    if h.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("expected h [N, H], w [H, V], b [V]")
    N, H = h.shape
    if w.shape[0] != H or b.shape[0] != w.shape[1]:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    V = w.shape[1]
    if N < 1 or H % 8 or V % 8:
        raise ValueError(f"need N >= 1 and H, V multiples of 8 (pad with "
                         f"prepad_head); got N={N}, H={H}, V={V}")
    if not (1 <= k <= min(KMAX, V)):
        raise ValueError(f"k must be in [1, {min(KMAX, V)}], got {k}")
    for name, t in (("h", h), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_head_topk(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    k: int):
    """(vals [N, k] fp32, idx [N, k] int32, lse [N] fp32) of h @ w + b.
    CUDA tensors: the kernel (counted in ``fused_head_topk.launches``);
    CPU tensors: ``reference_head_topk``."""
    if h.device.type == "cpu":
        return reference_head_topk(h, w, b, k)
    _check_cuda_inputs(h, w, b, k)
    lib = _library()
    N, H = h.shape
    V = w.shape[1]
    n_tiles = -(-V // TILE_V)
    dev = h.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    vals = torch.empty((N, k), **f32)
    idx = torch.empty((N, k), **i32)
    lse = torch.empty((N,), **f32)
    part_m = torch.empty((N * n_tiles,), **f32)
    part_s = torch.empty((N * n_tiles,), **f32)
    part_v = torch.empty((N * n_tiles * k,), **f32)
    part_i = torch.empty((N * n_tiles * k,), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ck_head_topk(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), lse.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), N, H, V, k, dev.index or 0,
        stream)
    if err:
        raise RuntimeError(f"head_topk launch failed: "
                           f"{lib.ck_error_string(err).decode()} ({err})")
    fused_head_topk.launches += 1
    return vals, idx, lse


fused_head_topk.launches = 0
