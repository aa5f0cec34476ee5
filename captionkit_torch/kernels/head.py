"""Fused vocab head: matmul + log-sum-exp + per-row top-k
(``captionkit.ops.head``; the kernels are ``csrc/head_topk.cu`` and
``csrc/head_int8.cu``).

Every head returns (vals [N, k] fp32 raw logits, descending, equal values
lowest index first; idx [N, k] int32; lse [N] fp32). On a CUDA tensor a
wrapper launches its hand-written kernel, which never writes the [N, V]
logits to device memory, or raises. On a CPU tensor it computes the same
function with its plain version, which forms the full logits.

- ``fused_head_topk(h, w, b, k=k, extract=...)``: logits = h @ w + b, bf16
  operands. ``extract="mask"`` and ``"thresh"`` are the reference's two
  in-kernel extractions (the second launches ``fused_head_topk_thresh``);
  their results are identical. With ``CAPTIONKIT_HEAD_SWEEP`` set (read
  once, at import, as the reference reads it) it runs ``head_sweep_topk``,
  the single-sweep kernel, and ignores ``extract``.
- ``fused_head_topk_int8(h, w_q, w_scale, b, k=k, extract=...)``: the
  int8 head of ``head_quant="int8"``: logits = (q8(h) @ w_q) * (s_h * s_w)
  + b, with fp32 h quantized per row inside the kernel and w_q from
  ``quantize_head``. Bit-identical to ``reference_head_topk_int8``'s
  values and ids.

``prepad_head`` and ``quantize_head`` prepare the head once per decode
batch: the vocab axis padded to a multiple of the kernels' 128-column
tile, padded columns with weight 0, bias ``HEAD_PAD`` (never in the top-k;
exp() = 0 in the log-sum-exp) and, for int8, scale 1.
"""

from __future__ import annotations

import ctypes
import os

import torch

from captionkit_torch.nn.topk import topk_lowest_index

HEAD_PAD = -1e30  # head padding; not the attention mask's NEG_INF
TILE_V = 128  # the kernels' vocab tile (BN in csrc/head_common.cuh)
KMAX = 8  # the kernels' largest k
EXTRACTS = ("mask", "thresh")
_EXTRACT_CODE = {"mask": 0, "thresh": 1}

#: ``CAPTIONKIT_HEAD_SWEEP``, read once at import: when set,
#: ``fused_head_topk`` runs the single-sweep kernel.
SWEEP = bool(os.environ.get("CAPTIONKIT_HEAD_SWEEP", ""))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division on every device. (PyTorch's CUDA division
    by a Python number multiplies by the reciprocal, which may differ in
    the last bit; a 0-dim tensor on x's device takes the true division.)"""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


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


def quantize_head(w: torch.Tensor, b: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8 quantization of the head (``head_quant=
    "int8"``): scale = max(max|w|, 1e-8) / 127, w_q = round(w / scale)
    (half to even, no clip). Returns (w_q int8 [H, Vp], w_scale fp32 [Vp],
    b fp32 [Vp]), Vp a multiple of TILE_V; padded columns have weight 0,
    scale 1 and bias HEAD_PAD. The reference pads to its own tile; the
    first V columns are the same."""
    H, V = w.shape
    Vp = _round_up(V, TILE_V)
    wf = w.float()
    scale = _div(wf.abs().amax(dim=0).clamp_min(1e-8), 127.0)
    w_q = torch.zeros((H, Vp), dtype=torch.int8, device=w.device)
    w_q[:, :V] = torch.round(wf / scale).to(torch.int8)
    scale_p = torch.ones((Vp,), dtype=torch.float32, device=w.device)
    scale_p[:V] = scale
    b_p = torch.full((Vp,), HEAD_PAD, dtype=torch.float32, device=b.device)
    b_p[:V] = b.float()
    return w_q, scale_p, b_p


def quantize_rows(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (the reference's ``_quantize_rows``): (h_q
    int8 [N, H], s_h fp32 [N, 1]) with s_h = max(max|h|, 1e-8) / 127 and
    h_q = round(h / s_h), half to even, no clip. Not the feature feed's
    quantizer, which clips and gives all-zero rows scale 1."""
    hf = h.float()
    s_h = _div(hf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(hf / s_h).to(torch.int8), s_h


def quantized_head_logits(h: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """The dequantized logits acc * (s_h * s_w) + b, acc = q8(h) @ w_q. The
    int8 products are summed in float64, which holds them exactly (|acc| <=
    H * 127^2 < 2^24 for H <= 1024, integers far below 2^53), so acc is
    the exact int32 sum on every device and in every order."""
    h_q, s_h = quantize_rows(h)
    acc = (h_q.double() @ w_q.double()).float()
    return acc * (s_h * w_scale[None, :]) + b


def reference_head_topk(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        k: int):
    """Plain version: full fp32 logits -> top-k with lowest-index ties +
    logsumexp. bf16 operands are exact in fp32, so this is the kernel's
    function up to the order of the fp32 sums."""
    logits = h.float() @ w.float() + b.float()
    vals, idx = topk_lowest_index(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=1)


def reference_head_topk_int8(h: torch.Tensor, w_q: torch.Tensor,
                             w_scale: torch.Tensor, b: torch.Tensor, k: int):
    """Plain version of the int8 head (the reference's
    ``xla_head_topk_int8``): ``quantized_head_logits`` -> top-k with
    lowest-index ties + logsumexp."""
    logits = quantized_head_logits(h, w_q, w_scale, b)
    vals, idx = topk_lowest_index(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=1)


def _check_extract(extract: str) -> None:
    if extract not in EXTRACTS:
        raise ValueError(
            f"extract must be 'mask' or 'thresh', got {extract!r}")


def _bind_common(lib: ctypes.CDLL, width: str, kmax: str) -> None:
    lib.ck_error_string.argtypes = [ctypes.c_int]
    lib.ck_error_string.restype = ctypes.c_char_p
    for name in (width, kmax):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    # The scratch sizes below are computed from these two constants.
    if (getattr(lib, width)(), getattr(lib, kmax)()) != (TILE_V, KMAX):
        raise RuntimeError("csrc/head_common.cuh and kernels/head.py "
                           "disagree on the vocab tile or the largest k")


_bound: dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    lib = _bound.get(name)
    if lib is not None:
        return lib
    from captionkit_torch.kernels import build

    lib = build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "head_topk":
        lib.ck_head_topk.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        lib.ck_head_topk.restype = i32
        lib.ck_head_sweep.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.ck_head_sweep.restype = i32
        _bind_common(lib, "ck_head_tile_width", "ck_head_kmax")
    else:
        lib.ck_head_topk_int8.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
        lib.ck_head_topk_int8.restype = i32
        _bind_common(lib, "ck_head_int8_tile_width", "ck_head_int8_kmax")
    _bound[name] = lib
    return lib


def _check_cuda_inputs(h, w, b, k, *, h_dtype, w_dtype, h_mult, v_mult,
                       scale=None):
    """Raise on what the kernel does not take: devices, dtypes, shapes,
    contiguity, alignment."""
    tensors = [("h", h), ("w", w), ("b", b)] + (
        [("w_scale", scale)] if scale is not None else [])
    if not (h.is_cuda and all(t.device == h.device for _, t in tensors)):
        raise ValueError(
            f"{', '.join(n for n, _ in tensors)} must be on the same CUDA "
            "device")
    if h.dtype != h_dtype or w.dtype != w_dtype:
        raise TypeError(f"the CUDA head takes {h_dtype} h and {w_dtype} w, "
                        f"got {h.dtype} and {w.dtype}")
    for name, t in tensors[2:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if h.dim() != 2 or w.dim() != 2 or any(t.dim() != 1
                                           for _, t in tensors[2:]):
        raise ValueError("expected h [N, H], w [H, V], b [V]")
    N, H = h.shape
    if w.shape[0] != H or any(t.shape[0] != w.shape[1]
                              for _, t in tensors[2:]):
        raise ValueError(
            f"shape mismatch: h {tuple(h.shape)}, w {tuple(w.shape)}, "
            + ", ".join(f"{n} {tuple(t.shape)}" for n, t in tensors[2:]))
    V = w.shape[1]
    if N < 1 or H % h_mult or V % v_mult:
        raise ValueError(
            f"need N >= 1, H a multiple of {h_mult} and V a multiple of "
            f"{v_mult} (pad with prepad_head / quantize_head); got N={N}, "
            f"H={H}, V={V}")
    if not (1 <= k <= min(KMAX, V)):
        raise ValueError(f"k must be in [1, {min(KMAX, V)}], got {k}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _outputs(N: int, k: int, dev: torch.device, n_tiles: int = 0):
    """vals, idx, lse, and the pass-1 partials (m, s, v, i) for n_tiles."""
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.empty((N, k), **f32), torch.empty((N, k), **i32),
            torch.empty((N,), **f32), torch.empty((N * n_tiles,), **f32),
            torch.empty((N * n_tiles,), **f32),
            torch.empty((N * n_tiles * k,), **f32),
            torch.empty((N * n_tiles * k,), **i32))


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.ck_error_string(err).decode()} ({err})")


def _launch_tiled(h, w, b, k, extract, wrapper):
    _check_cuda_inputs(h, w, b, k, h_dtype=torch.bfloat16,
                       w_dtype=torch.bfloat16, h_mult=8, v_mult=8)
    lib = _library("head_topk")
    N, H = h.shape
    V = w.shape[1]
    dev = h.device
    vals, idx, lse, pm, ps, pv, pi = _outputs(N, k, dev, -(-V // TILE_V))
    err = lib.ck_head_topk(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), lse.data_ptr(), pm.data_ptr(), ps.data_ptr(),
        pv.data_ptr(), pi.data_ptr(), N, H, V, k, _EXTRACT_CODE[extract],
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "head_topk")
    wrapper.launches += 1
    return vals, idx, lse


def fused_head_topk(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    k: int, extract: str = "mask"):
    """(vals [N, k] fp32, idx [N, k] int32, lse [N] fp32) of h @ w + b.
    CUDA tensors: the kernel (``extract="mask"`` counted in
    ``fused_head_topk.launches``; ``"thresh"`` runs
    ``fused_head_topk_thresh``; with SWEEP set, ``head_sweep_topk``);
    CPU tensors: ``reference_head_topk``."""
    _check_extract(extract)
    if SWEEP:
        return head_sweep_topk(h, w, b, k=k)
    if extract == "thresh":
        return fused_head_topk_thresh(h, w, b, k=k)
    if h.device.type == "cpu":
        return reference_head_topk(h, w, b, k)
    return _launch_tiled(h, w, b, k, "mask", fused_head_topk)


def fused_head_topk_thresh(h: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, *, k: int):
    """The head with the read-only threshold extraction
    (``extract="thresh"``): the same results as ``fused_head_topk``'s mask
    extraction, bit for bit. CUDA: counted in
    ``fused_head_topk_thresh.launches``; CPU: ``reference_head_topk``."""
    if h.device.type == "cpu":
        return reference_head_topk(h, w, b, k)
    return _launch_tiled(h, w, b, k, "thresh", fused_head_topk_thresh)


def head_sweep_topk(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    k: int):
    """The single-sweep head (the reference's ``_sweep_head_topk``): one
    launch, each block walking the whole vocab for its rows. CUDA: counted
    in ``head_sweep_topk.launches``; CPU: ``reference_head_topk``."""
    if h.device.type == "cpu":
        return reference_head_topk(h, w, b, k)
    _check_cuda_inputs(h, w, b, k, h_dtype=torch.bfloat16,
                       w_dtype=torch.bfloat16, h_mult=8, v_mult=8)
    lib = _library("head_topk")
    N, H = h.shape
    V = w.shape[1]
    dev = h.device
    vals, idx, lse, *_ = _outputs(N, k, dev)
    err = lib.ck_head_sweep(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), lse.data_ptr(), N, H, V, k, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "head_sweep")
    head_sweep_topk.launches += 1
    return vals, idx, lse


def fused_head_topk_int8(h: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor, b: torch.Tensor, *, k: int,
                         extract: str = "mask"):
    """(vals, idx, lse) of the int8 head over fp32 h [N, H] and
    ``quantize_head``'s (w_q [H, Vp] int8, w_scale [Vp], b [Vp]). CUDA: the
    kernel, either extraction (counted in ``fused_head_topk_int8
    .launches``); CPU: ``reference_head_topk_int8``."""
    _check_extract(extract)
    if h.device.type == "cpu":
        return reference_head_topk_int8(h, w_q, w_scale, b, k)
    _check_cuda_inputs(h, w_q, b, k, h_dtype=torch.float32,
                       w_dtype=torch.int8, h_mult=4, v_mult=16,
                       scale=w_scale)
    lib = _library("head_int8")
    N, H = h.shape
    V = w_q.shape[1]
    dev = h.device
    vals, idx, lse, pm, ps, pv, pi = _outputs(N, k, dev, -(-V // TILE_V))
    err = lib.ck_head_topk_int8(
        h.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), b.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), pm.data_ptr(),
        ps.data_ptr(), pv.data_ptr(), pi.data_ptr(), N, H, V, k,
        _EXTRACT_CODE[extract], dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "head_topk_int8")
    fused_head_topk_int8.launches += 1
    return vals, idx, lse


fused_head_topk.launches = 0
fused_head_topk_thresh.launches = 0
head_sweep_topk.launches = 0
fused_head_topk_int8.launches = 0
