"""Fused vocab head: matmul + log-sum-exp + per-row top-k
(``captionkit.ops.head``; the kernels are ``csrc/head_topk.cu``,
``csrc/head_sweep.cu`` and ``csrc/head_int8.cu``, all three on the one
kernel template of ``csrc/head_sm90.cuh`` for bf16, fp32 and int8).

Every head returns (vals [N, k] fp32 raw logits, descending, equal values
lowest index first; idx [N, k] int32; lse [N] fp32). On a CUDA tensor a
wrapper launches its hand-written kernel, which never writes the [N, V]
logits to device memory, or raises. On a CPU tensor it computes the same
function with its plain version, which forms the full logits.

- ``fused_head_topk(h, w, b, k=k, extract=...)``: logits = h @ w + b, h
  and w both bf16 or both fp32 (``compute_dtype="float32"``: fp32 products
  on the CUDA cores, not TF32). ``extract="mask"`` and ``"thresh"`` are the
  reference's two in-kernel extractions (the second launches
  ``fused_head_topk_thresh``); their results are identical. With
  ``CAPTIONKIT_HEAD_SWEEP`` set (read once, at import, as the reference
  reads it) it runs ``head_sweep_topk``, the single-sweep kernel, and
  ignores ``extract``.
- ``fused_head_topk_int8(h, w_q, w_scale, b, k=k, extract=..., w_qt=...)``:
  the int8 head of ``head_quant="int8"``: logits = (q8(h) @ w_q) * (s_h *
  s_w) + b, with fp32 h quantized per row inside the kernel and w_q from
  ``quantize_head``; the kernel reads ``w_qt = kmajor_head(w_q)``, the
  K-major copy that 8-bit wgmma needs. Bit-identical to
  ``reference_head_topk_int8``'s values and ids.

Every kernel runs one launch a call: for each block of 64 rows a cluster of
CTAs splits the vocab (``sweep_plan``, from the clusters the card holds,
``cluster_table``) and merges on chip; no partial result reaches device
memory. Every kernel takes any k up to ``KMAX`` (64): its candidate lists
are template instances of 8, 16, 32 and 64 entries and the smallest that
holds k runs; above ``KMAX`` a CUDA call raises. Any H: the bf16 and int8
kernels keep h (or the quantized rows) resident up to
``SWEEP_RESIDENT_H`` and stream it beside W above; the fp32 kernels
always stream h.

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
KMAX = 64  # the kernels' largest k (KMAX_LIMIT in csrc/head_common.cuh)
EXTRACTS = ("mask", "thresh")
_EXTRACT_CODE = {"mask": 0, "thresh": 1}

#: ``CAPTIONKIT_HEAD_SWEEP``, read once at import: when set,
#: ``fused_head_topk`` runs the single-sweep kernel.
SWEEP = bool(os.environ.get("CAPTIONKIT_HEAD_SWEEP", ""))
# The kernels of csrc/head_sm90.cuh (which rejects other values): 64 rows a
# CTA, h resident up to H = 1024 and streamed with W above (fp32: always
# streamed), the vocab split over the CTAs of a cluster: at most 4 of them
# for bf16 and int8 (the sweep's k <= 8 instance merges 8 partial states a
# warpgroup and row), at most 8 for fp32 (one warpgroup holds a row's state).
SWEEP_ROWS = 64
SWEEP_RESIDENT_H = 1024
SWEEP_MAX_SHARES = 4
F32_MAX_SHARES = 8


def kmax_for(k: int) -> int:
    """The candidate-list instance a kernel runs for k: the smallest of 8,
    16, 32 and 64 that holds it (``kmax_for`` in csrc/head_common.cuh).
    Raises above ``KMAX``, the largest instance."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"k must be in [1, {KMAX}] (the head kernels' "
                         f"largest candidate list), got {k}")
    return next(m for m in (8, 16, 32, 64) if k <= m)


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


def kmajor_head(w_q: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's K-major copy of ``quantize_head``'s w_q [H, Vp]:
    w_qt [Vp, Hp] int8, w_qt[v, :H] = w_q[:, v], zeros in the columns up
    to Hp = H rounded up to 16 (a TMA row is a multiple of 16 bytes).
    8-bit wgmma reads both operands K-major only; ``prepare_topk`` makes
    this once a batch, beside ``quantize_head``."""
    H, Vp = w_q.shape
    w_qt = w_q.new_zeros((Vp, _round_up(H, 16)))
    w_qt[:, :H] = w_q.t()
    return w_qt


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
    H * 127^2, integers far below 2^53), so acc is the exact int32 sum on
    every device and in every order, rounded once to fp32 as the kernel
    converts its int32 sum."""
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
    # The padding (prepad_head, quantize_head) and the plans use these two.
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
        for entry in ("ck_head_topk", "ck_head_topk_f32"):
            getattr(lib, entry).argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
            getattr(lib, entry).restype = i32
        _bind_common(lib, "ck_head_tile_width", "ck_head_kmax")
    elif name == "head_sweep":
        for entry in ("ck_head_sweep", "ck_head_sweep_f32"):
            getattr(lib, entry).argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
            getattr(lib, entry).restype = i32
        _bind_common(lib, "ck_head_sweep_tile_width", "ck_head_sweep_kmax")
        lib.ck_head_sweep_resident_h.argtypes = []
        lib.ck_head_sweep_resident_h.restype = i32
        if lib.ck_head_sweep_resident_h() != SWEEP_RESIDENT_H:
            raise RuntimeError("csrc/head_sm90.cuh and kernels/head.py "
                               "disagree on the resident h width")
    else:
        lib.ck_head_topk_int8.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        _bind_common(lib, "ck_head_int8_tile_width", "ck_head_int8_kmax")
    entry, *clusters = _ENTRIES[name]
    getattr(lib, entry).restype = i32
    for query in clusters:
        getattr(lib, query).argtypes = [i32, i32, i32]
        getattr(lib, query).restype = i32
    _bound[name] = lib
    return lib


# Each library's bf16 or int8 entry and its clusters queries (bf16 or int8,
# then fp32).
_ENTRIES = {
    "head_topk": ("ck_head_topk", "ck_head_topk_max_clusters",
                  "ck_head_topk_f32_max_clusters"),
    "head_sweep": ("ck_head_sweep", "ck_head_sweep_max_clusters",
                   "ck_head_sweep_f32_max_clusters"),
    "head_int8": ("ck_head_topk_int8", "ck_head_int8_max_clusters"),
}


def _check_cuda_inputs(h, w, b, k, *, h_dtype, w_dtype, h_mult, v_mult,
                       scale=None):
    """Raise on what the kernel does not take: devices, dtypes, shapes,
    k, contiguity, alignment."""
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
    kmax_for(k)
    if k > V:
        raise ValueError(f"k must be at most V = {V}, got {k}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _outputs(N: int, k: int, dev: torch.device):
    """vals [N, k], idx [N, k], lse [N]."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((N, k), **f32),
            torch.empty((N, k), dtype=torch.int32, device=dev),
            torch.empty((N,), **f32))


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.ck_error_string(err).decode()} ({err})")


def _float_dtype(h: torch.Tensor) -> torch.dtype:
    """The float heads' compute dtype, from h: bf16, or fp32 for
    ``compute_dtype="float32"`` (w must match)."""
    return torch.float32 if h.dtype == torch.float32 else torch.bfloat16


def head_plan(name: str, h: torch.Tensor, V: int) -> tuple[int, int]:
    """``sweep_plan`` of the kernel of library ``name`` ("head_topk",
    "head_sweep") for h [N, H] (bf16 or fp32) on its device: (shares,
    tiles per share)."""
    N, H = h.shape
    fp32 = h.dtype == torch.float32
    return sweep_plan(N, V, cluster_table(
        name, h.device, not fp32 and H > SWEEP_RESIDENT_H, fp32=fp32))


def _launch_tiled(h, w, b, k, extract, wrapper, fault=0):
    """The tiled head's kernel, bf16 or fp32: one launch (``sweep_plan``'s
    clusters; ``fault=1`` plants a tile skip on a max equal to the running
    k-th value, for tests)."""
    dt = _float_dtype(h)
    _check_cuda_inputs(h, w, b, k, h_dtype=dt, w_dtype=dt, h_mult=8,
                       v_mult=8)
    lib = _library("head_topk")
    N, H = h.shape
    V = w.shape[1]
    dev = h.device
    vals, idx, lse = _outputs(N, k, dev)
    shares, _ = head_plan("head_topk", h, V)
    entry = lib.ck_head_topk_f32 if dt == torch.float32 else lib.ck_head_topk
    err = entry(h.data_ptr(), w.data_ptr(), b.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), lse.data_ptr(), N, H, V, k,
                _EXTRACT_CODE[extract], shares, fault, dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "head_topk")
    wrapper.launches += 1
    return vals, idx, lse


def fused_head_topk(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    k: int, extract: str = "mask"):
    """(vals [N, k] fp32, idx [N, k] int32, lse [N] fp32) of h @ w + b.
    CUDA tensors: the kernel (``extract="mask"`` counted in
    ``fused_head_topk.launches``; ``"thresh"`` runs
    ``fused_head_topk_thresh``; with SWEEP set, ``head_sweep_topk``); h
    and w bf16, or both fp32; CPU tensors: ``reference_head_topk``."""
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


def sweep_plan(N: int, V: int, clusters) -> tuple[int, int]:
    """The launch plan of the kernels of csrc/head_sm90.cuh (the sweep, the
    tiled heads, the int8 head, the fp32 whole step's head): (shares,
    tiles per share). Each block of ``SWEEP_ROWS`` rows is
    one cluster of ``shares`` CTAs; CTA c sweeps vocab tiles [c P, (c + 1)
    P) of ``TILE_V`` columns (the last share may be short or empty),
    starting at tile c P + (row block mod its tiles). ``clusters[s]`` is how
    many clusters of s CTAs the card holds at once (``cluster_table``, s = 1
    .. len(clusters) - 1); the plan takes the shares, at most the table's
    largest s and the number of tiles, that minimise waves x tiles per
    share, the fewer waves on a tie."""
    row_blocks = -(-N // SWEEP_ROWS)
    n_tiles = -(-V // TILE_V)
    best = None
    for shares in range(1, min(len(clusters) - 1, n_tiles) + 1):
        if clusters[shares] < 1:
            continue
        per = -(-n_tiles // shares)
        waves = -(-row_blocks // clusters[shares])
        key = (waves * per, waves)
        if best is None or key < best[0]:
            best = (key, shares, per)
    if best is None:
        raise RuntimeError("the card holds no cluster of the head kernel")
    return best[1], best[2]


_clusters: dict[tuple[str, int, bool, bool], tuple[int, ...]] = {}


def query_clusters(query, device: int, wide: bool, error_string, what: str,
                   max_shares: int = SWEEP_MAX_SHARES) -> tuple[int, ...]:
    """(0, n_1, .., n_max_shares): ``query(s, wide, device)``, a library's
    clusters query, for each cluster size s; raises with
    ``error_string(code)`` where a query fails."""
    counts = [query(s, int(wide), device)
              for s in range(1, max_shares + 1)]
    for s, n in enumerate(counts, 1):
        if n < 0:
            raise RuntimeError(f"{what} cluster query ({s} CTAs) failed: "
                               f"{error_string(-n).decode()} ({-n})")
    return (0, *counts)


def cluster_table(name: str, device: torch.device, wide: bool = False, *,
                  fp32: bool = False) -> tuple[int, ...]:
    """How many clusters of s CTAs (index s = 1 .. SWEEP_MAX_SHARES) of the
    kernel of library ``name`` ("head_topk", "head_sweep", "head_int8") the
    card holds at once, from the occupancy API, for h resident or
    (``wide``, H > SWEEP_RESIDENT_H) streamed, or of its fp32 kernel
    (``fp32``; h always streamed; s up to F32_MAX_SHARES); once per kernel,
    device and layout."""
    key = (name, device.index or 0, wide, fp32)
    table = _clusters.get(key)
    if table is None:
        lib = _library(name)
        query = getattr(lib, _ENTRIES[name][2 if fp32 else 1])
        table = _clusters[key] = query_clusters(
            query, key[1], wide, lib.ck_error_string, name,
            F32_MAX_SHARES if fp32 else SWEEP_MAX_SHARES)
    return table


def head_sweep_topk(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    k: int):
    """The single-sweep head (the reference's ``_sweep_head_topk``): one
    launch, no partials in device memory: a cluster of CTAs sweeps the
    vocab for each block of 64 rows (``sweep_plan``) and merges on chip.
    bf16: h stays resident up to H = 1024 and streams beside W above; fp32
    (``compute_dtype="float32"``): fp32 FMA on the CUDA cores, h streamed.
    CUDA: counted in ``head_sweep_topk.launches``; CPU:
    ``reference_head_topk``."""
    if h.device.type == "cpu":
        return reference_head_topk(h, w, b, k)
    dt = _float_dtype(h)
    _check_cuda_inputs(h, w, b, k, h_dtype=dt, w_dtype=dt, h_mult=8,
                       v_mult=8)
    N, H = h.shape
    lib = _library("head_sweep")
    V = w.shape[1]
    dev = h.device
    vals, idx, lse = _outputs(N, k, dev)
    shares, _ = head_plan("head_sweep", h, V)
    entry = (lib.ck_head_sweep_f32 if dt == torch.float32
             else lib.ck_head_sweep)
    err = entry(h.data_ptr(), w.data_ptr(), b.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), lse.data_ptr(), N, H, V, k, shares,
                dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "head_sweep")
    head_sweep_topk.launches += 1
    return vals, idx, lse


def _launch_int8(h, w_q, w_scale, b, k, extract, w_qt, fault=0):
    """The int8 kernel, one launch (``fault`` as ``_launch_tiled``'s)."""
    _check_cuda_inputs(h, w_q, b, k, h_dtype=torch.float32,
                       w_dtype=torch.int8, h_mult=4, v_mult=16,
                       scale=w_scale)
    N, H = h.shape
    V = w_q.shape[1]
    Hp = _round_up(H, 16)
    if w_qt is None:
        w_qt = kmajor_head(w_q)
    if (w_qt.dtype != torch.int8 or w_qt.device != h.device
            or tuple(w_qt.shape) != (V, Hp) or not w_qt.is_contiguous()
            or w_qt.data_ptr() % 16):
        raise ValueError(f"w_qt must be kmajor_head(w_q): contiguous int8 "
                         f"[{V}, {Hp}] on {h.device}, got {w_qt.dtype} "
                         f"{tuple(w_qt.shape)} on {w_qt.device}")
    lib = _library("head_int8")
    dev = h.device
    shares, _ = sweep_plan(
        N, V, cluster_table("head_int8", dev, Hp > SWEEP_RESIDENT_H))
    vals, idx, lse = _outputs(N, k, dev)
    qh = torch.empty((shares * _round_up(N, SWEEP_ROWS), Hp),
                     dtype=torch.int8, device=dev)
    err = lib.ck_head_topk_int8(
        h.data_ptr(), w_qt.data_ptr(), w_scale.data_ptr(), b.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), qh.data_ptr(), N, H,
        V, k, _EXTRACT_CODE[extract], shares, fault, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "head_topk_int8")
    fused_head_topk_int8.launches += 1
    return vals, idx, lse


def fused_head_topk_int8(h: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor, b: torch.Tensor, *, k: int,
                         extract: str = "mask",
                         w_qt: torch.Tensor | None = None):
    """(vals, idx, lse) of the int8 head over fp32 h [N, H] and
    ``quantize_head``'s (w_q [H, Vp] int8, w_scale [Vp], b [Vp]), any H.
    CUDA: the kernel, either extraction, one launch (counted in
    ``fused_head_topk_int8.launches``); it reads ``w_qt``, the K-major
    copy ``kmajor_head(w_q)``, made here when not given (a copy launch
    beside the kernel; ``prepare_topk`` makes it once a batch). CPU:
    ``reference_head_topk_int8``."""
    _check_extract(extract)
    if h.device.type == "cpu":
        return reference_head_topk_int8(h, w_q, w_scale, b, k)
    return _launch_int8(h, w_q, w_scale, b, k, extract, w_qt)


fused_head_topk.launches = 0
fused_head_topk_thresh.launches = 0
head_sweep_topk.launches = 0
fused_head_topk_int8.launches = 0
