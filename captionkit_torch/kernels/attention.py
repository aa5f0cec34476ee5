"""Fused additive attention (``captionkit.ops.attention``; the kernel is
``csrc/attention.cu``), the attention ``nn.dispatch`` returns with
``use_pallas=True``.

``fused_additive_attention(params, keys, values, query, mask=None, *,
compute_dtype, w_q=None)`` is a drop-in for ``nn.attention
.additive_attention`` (``w_q`` is the query projection already in the
compute dtype) and returns (ctx [B, V] fp32, weights [B, N] fp32). It
computes the TPU kernel's function, which differs from the plain
attention's in one place: the weights enter the context product in fp32,
where the plain attention first rounds them to the values' dtype. The mask
is reduced to a valid-prefix count per row, as the TPU kernel reduces it
(the framework's masks are length masks); positions at or past it score
``NEG_INF``.

On a CUDA tensor the wrapper launches the kernel (counted in
``fused_additive_attention.launches``) or raises: in bf16 the query
product on wgmma, then ``context_kernel``, which streams each row's keys
and values through a shared-memory ring and computes the scores, softmax
and context, started early as a programmatic dependent so that its loads
overlap the product; in fp32 (``compute_dtype=float32``, products on the
CUDA cores, not TF32) the same two launches, the product on the fp32
tile split over K (``megastep.f32_split``) and ``context_kernel``'s fp32
instance. It takes keys in the compute dtype and one query row per key
row (no grouped beam layout, as the TPU kernel). On a CPU tensor it runs
``reference_additive_attention``, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from captionkit_torch.kernels.megastep import (
    LANE,
    _check,
    _pad_to,
    _qpad,
    _round_up,
    _stream,
    _vec,
    f32_split,
)
from captionkit_torch.nn.attention import AdditiveAttentionParams
from captionkit_torch.nn.cells import mm
from captionkit_torch.nn.masking import NEG_INF

K_TILE = 32  # the query product's K granularity (cell_common.cuh BK)
V_VEC = 8  # the context columns a thread owns (one 16-byte bf16 load)
QUERY_SPLIT = 4  # the most K ranges of the bf16 query product (QK_SPLIT)
QUERY_TILE = 128  # rows and columns of one of its output tiles


def query_split(B: int, Ap: int, sms: int) -> int:
    """The K ranges (partials) of the bf16 query product at B rows and Ap
    columns: QUERY_SPLIT, halved while its CTAs (a range of a 128 x 128
    tile each) would fill more than one wave of the card's ``sms`` SMs."""
    tiles = (Ap // QUERY_TILE) * -(-B // QUERY_TILE)
    split = QUERY_SPLIT
    while split > 1 and split * tiles > sms:
        split //= 2
    return split


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def valid_counts(mask: Optional[torch.Tensor], B: int, N: int,
                 device) -> torch.Tensor:
    """[B] int32: the valid-prefix length of each row's mask (N without
    one)."""
    if mask is None:
        return torch.full((B,), N, dtype=torch.int32, device=device)
    return mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def reference_additive_attention(
    params: AdditiveAttentionParams, keys, values, query, mask=None, *,
    compute_dtype: torch.dtype = torch.float32,
    w_q: Optional[torch.Tensor] = None,
):
    """The kernel's arithmetic: qa = q Wq (operands in the compute dtype,
    fp32 sums), e = tanh(keys + qa + b), s = e . v, s = NEG_INF past the
    valid prefix, fp32 softmax, ctx = sum_n w_n values_n with fp32 w and
    the values rounded to the compute dtype. Query rows may be grouped G
    to a key row, as the plain attention allows."""
    dt = compute_dtype
    kB, N, _ = keys.shape
    qB = query.shape[0]
    if qB % kB:
        raise ValueError(
            f"query batch {qB} is not a multiple of key batch {kB}")
    G = qB // kB
    qa = mm(query, params.w_q if w_q is None else w_q, dt)
    e = torch.tanh(keys.float()[:, None] + qa.reshape(kB, G, 1, -1)
                   + params.b.float())
    scores = e @ params.v.float()  # [kB, G, N]
    nvalid = valid_counts(mask, kB, N, keys.device)
    pos = torch.arange(N, device=keys.device)
    scores = torch.where(pos[None, None, :] < nvalid[:, None, None], scores,
                         NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = w @ values.to(dt).float()  # [kB, G, V]
    return ctx.reshape(qB, -1), w.reshape(qB, N)


# --------------------------------------------------------------------------
# CUDA wrapper
# --------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from captionkit_torch.kernels import build

        lib = build.load("attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ck_additive_attention.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.ck_additive_attention.restype = i
        for name in ("ck_attention_width", "ck_attention_query_split"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.ck_attention_error_string.argtypes = [i]
        lib.ck_attention_error_string.restype = ctypes.c_char_p
        if (lib.ck_attention_width(), lib.ck_attention_query_split()) != (
                LANE, QUERY_SPLIT):
            raise RuntimeError("csrc/attention.cu and kernels/attention.py "
                               "disagree on the query product's width or "
                               "K ranges")
        _LIB = lib
    return _LIB


def _kernel_weights(params: AdditiveAttentionParams, w_q, Q: int, A: int,
                    dt: torch.dtype):
    """(wq [Qp, Ap] in dt, b [Ap], v [Ap] fp32) at the kernel's widths:
    ``w_q`` itself when Q and A are aligned, else a padded copy built once
    per parameter object and dtype (``params.cache``)."""
    Qp, Ap = _round_up(Q, K_TILE), _round_up(A, LANE)
    if (Qp, Ap) == (Q, A) and w_q is not None and w_q.dtype == dt:
        return w_q.contiguous(), _vec(params.b, Ap), _vec(params.v, Ap)
    key = ("kernel_pack", dt)
    w = params.cache.get(key)
    if w is None:
        w = (_qpad(params.w_q, Qp, Ap, dt), _vec(params.b, Ap),
             _vec(params.v, Ap))
        params.cache[key] = w
    return w


def fused_additive_attention(
    params: AdditiveAttentionParams, keys, values, query, mask=None, *,
    compute_dtype: torch.dtype = torch.float32,
    w_q: Optional[torch.Tensor] = None,
):
    """(ctx [B, V] fp32, weights [B, N] fp32) of the TPU kernel's
    function. CUDA tensors: ``csrc/attention.cu::ck_additive_attention``
    (2 launches), counted in ``fused_additive_attention.launches``; CPU
    tensors: ``reference_additive_attention``."""
    if query.device.type == "cpu":
        return reference_additive_attention(
            params, keys, values, query, mask, compute_dtype=compute_dtype,
            w_q=w_q)
    dt, dev = compute_dtype, query.device
    bf, f32 = torch.bfloat16, torch.float32
    if dt not in (bf, f32):
        raise TypeError("the CUDA attention kernel computes in bfloat16 or "
                        f"float32; got compute_dtype={dt}")
    if keys.dtype != dt:
        raise TypeError(f"keys must be {dt} (the compute dtype) on the card, "
                        f"got {keys.dtype}")
    B, N, A = keys.shape
    Vd = values.shape[-1]
    Q = query.shape[1]
    if query.shape[0] != B:
        raise ValueError(
            f"the kernel takes one query row per key row: query batch "
            f"{query.shape[0]}, key batch {B} (no grouped beam layout)")
    wq, b, v = _kernel_weights(params, w_q, Q, A, dt)
    Qp, Ap = wq.shape
    Vp = _round_up(Vd, V_VEC)
    if query.dtype not in (f32, bf):
        raise TypeError(f"the query must be fp32 or bf16, got {query.dtype}")
    q = _pad_to(query.float() if dt == f32 else query, 1, Qp).contiguous()
    keys_k = _pad_to(keys, 2, Ap).contiguous()
    values_k = _pad_to(values.to(dt), 2, Vp).contiguous()
    nvalid = valid_counts(mask, B, N, dev)
    _check(dev, q=(q, q.dtype, (B, Qp)), wq=(wq, dt, (Qp, Ap)),
           b=(b, f32, (Ap,)), v=(v, f32, (Ap,)),
           keys=(keys_k, dt, (B, N, Ap)), values=(values_k, dt, (B, N, Vp)),
           nvalid=(nvalid, torch.int32, (B,)))
    lib = _library()
    ctx = torch.empty((B, Vp), dtype=f32, device=dev)
    w = torch.empty((B, N), dtype=f32, device=dev)
    # The query product's K-range partials.
    index = dev.index or 0
    split = (f32_split(B, Qp, Ap, index) if dt == f32
             else query_split(B, Ap, _sms(index)))
    qa = torch.empty((split, B, Ap), dtype=f32, device=dev)
    err = lib.ck_additive_attention(
        *(t.data_ptr() for t in (q, wq, b, v, keys_k, values_k, nvalid, ctx,
                                 w, qa)),
        B, Qp, Ap, N, Vp, int(q.dtype == f32), int(dt == f32), split, index,
        _stream(dev))
    if err:
        raise RuntimeError(
            "ck_additive_attention launch failed: "
            f"{lib.ck_attention_error_string(err).decode()} ({err})")
    fused_additive_attention.launches += 1
    return (ctx[:, :Vd] if Vp != Vd else ctx), w


fused_additive_attention.launches = 0
