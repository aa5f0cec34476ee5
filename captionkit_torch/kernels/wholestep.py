"""Whole-step kernel: EditNet's lang cell and the vocab head in one launch
(``captionkit.ops.wholestep``; the kernel is ``csrc/wholestep.cu``).
Selected by ``cell_impl="wholestep"`` for beam decode (soft SCMA, float
head).

``fused_lang_head_topk`` is ``lang_cell`` (``kernels/megastep.py``) whose
new h_lang, rounded to the compute dtype, feeds the fused head's top-k and
log-sum-exp (``kernels/head.py``, ``extract="mask"``) inside the launch:
(h_lang', c_lang', vals [N, k], idx [N, k], lse [N]). ``fused_step_topk``
is the whole decode step: ``att_phase`` (``att_cell`` and the grouped
α→v̂, β→c* products), then ``fused_lang_head_topk``.

On a CUDA tensor the wrapper launches the kernel or raises (counted in
``fused_lang_head_topk.launches``): with a bf16 pack, one persistent
cooperative launch on ``csrc/sm90_cell.cuh`` (the visual gate, the
Copy-LSTM, the head tiles and the merge, phases apart by grid syncs); with
an fp32 pack (``compute_dtype="float32"``), the fp32 route: the fp32 gate
and Copy-LSTM tiles (``csrc/cell_common.cuh``), then the fp32 single-sweep
head of ``csrc/head_sm90.cuh`` over h_lang' (one launch, clusters that
split the vocab by ``head.sweep_plan``), three launches. Any k up to ``head.KMAX``. On a CPU tensor it runs
``reference_lang_head_topk``: ``reference_lang_cell``, then
``reference_head_topk`` of h_lang' in the compute dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from captionkit_torch.kernels.head import (
    F32_MAX_SHARES,
    TILE_V,
    kmax_for,
    query_clusters,
    reference_head_topk,
    sweep_plan,
)
from captionkit_torch.kernels.megastep import (
    CellPack,
    _check,
    _pack_dtype,
    _pad_to,
    _stream,
    att_phase,
    reference_lang_cell,
)


def _padded(pack: CellPack, h_lang, c_lang, head_w):
    Hp = pack.hp
    return (_pad_to(h_lang, 1, Hp).contiguous(),
            _pad_to(c_lang, 1, Hp).contiguous(), _pad_to(head_w, 0, Hp))


def reference_lang_head_topk(pack: CellPack, vhat_raw, h_att2, c_star,
                             h_lang, c_lang, head_w, head_b, *, k: int):
    """The kernel's function in PyTorch, with the wrapper's signature:
    ``reference_lang_cell`` on the padded operands, then
    ``reference_head_topk`` of h_lang' rounded to the pack's dtype.
    Returns (h_lang', c_lang' [N, H], vals, idx, lse)."""
    H = h_lang.shape[1]
    h_lang, c_lang, head_w = _padded(pack, h_lang, c_lang, head_w)
    h, c = reference_lang_cell(pack, vhat_raw, h_att2, h_lang, c_lang,
                               c_star)
    vals, idx, lse = reference_head_topk(h.to(pack.dtype), head_w, head_b, k)
    return h[:, :H], c[:, :H], vals, idx, lse


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from captionkit_torch.kernels import build

        lib = build.load("wholestep")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ck_lang_head_topk.argtypes = [p] * 30 + [i] * 6 + [p]
        lib.ck_lang_head_topk_f32.argtypes = [p] * 24 + [i] * 7 + [p]
        lib.ck_wholestep_head_f32_max_clusters.argtypes = [i] * 3
        for name in ("ck_lang_head_topk", "ck_lang_head_topk_f32",
                     "ck_wholestep_grid", "ck_wholestep_regs",
                     "ck_wholestep_smem", "ck_wholestep_threads",
                     "ck_wholestep_head_f32_max_clusters"):
            getattr(lib, name).restype = i
        lib.ck_wholestep_grid.argtypes = [i]
        lib.ck_wholestep_regs.argtypes = []
        lib.ck_wholestep_smem.argtypes = []
        lib.ck_wholestep_threads.argtypes = []
        lib.ck_wholestep_error_string.argtypes = [i]
        lib.ck_wholestep_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch_info(device: int = 0) -> dict:
    """The cooperative kernel's grid on ``device`` (resident CTAs per SM x
    SMs), registers per thread, dynamic shared memory and threads per
    CTA."""
    lib = _library()
    return {"grid": lib.ck_wholestep_grid(device),
            "regs_per_thread": lib.ck_wholestep_regs(),
            "smem_bytes": lib.ck_wholestep_smem(),
            "threads": lib.ck_wholestep_threads()}


_f32_clusters: dict[int, tuple[int, ...]] = {}


def f32_head_plan(N: int, V: int, device: torch.device) -> tuple[int, int]:
    """``head.sweep_plan`` of the fp32 route's head kernel (the clusters
    the card holds of it, queried once per device): (shares, tiles per
    share)."""
    dev = device.index or 0
    table = _f32_clusters.get(dev)
    if table is None:
        lib = _library()
        table = _f32_clusters[dev] = query_clusters(
            lib.ck_wholestep_head_f32_max_clusters, dev, True,
            lib.ck_wholestep_error_string, "wholestep fp32 head",
            F32_MAX_SHARES)
    return sweep_plan(N, V, table)


def _lang_head_kernel(pack: CellPack, vhat_raw, h_att, h_lang, c_lang,
                      c_star, head_w, head_b, k: int):
    dev, f32 = vhat_raw.device, torch.float32
    dt, is_f32 = _pack_dtype(pack)
    N, Fp = vhat_raw.shape
    Hp = pack.hp
    V = head_w.shape[1]
    if V % TILE_V:
        raise ValueError(f"the head's vocab width must be a multiple of "
                         f"{TILE_V} (prepad_head), got {V}")
    kmax_for(k)
    if k > V:
        raise ValueError(f"k must be at most V = {V}, got {k}")
    _check(dev, vhat_raw=(vhat_raw, f32, (N, Fp)),
           h_att=(h_att, f32, (N, Hp)), h_lang=(h_lang, f32, (N, Hp)),
           c_lang=(c_lang, f32, (N, Hp)), c_star=(c_star, f32, (N, Hp)),
           gate_w=(pack.gate_w, dt, (Hp, Fp)),
           gate_b=(pack.gate_b, f32, (Fp,)),
           lang_wv=(pack.lang_wv, dt, (Fp, 4 * Hp)),
           lang_wha=(pack.lang_wha, dt, (Hp, 4 * Hp)),
           lang_wh=(pack.lang_wh, dt, (Hp, 4 * Hp)),
           lang_b=(pack.lang_b, f32, (4 * Hp,)),
           wr_v=(pack.wr_v, dt, (Fp, Hp)), wr_ha=(pack.wr_ha, dt, (Hp, Hp)),
           wr_hl=(pack.wr_hl, dt, (Hp, Hp)), wr_c=(pack.wr_c, dt, (Hp, Hp)),
           br=(pack.br, f32, (Hp,)), head_w=(head_w, dt, (Hp, V)),
           head_b=(head_b, f32, (V,)))
    lib = _library()
    n_tiles = V // TILE_V

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    h_out, c_out = empty((N, Hp), f32), empty((N, Hp), f32)
    vals, idx, lse = empty((N, k), f32), empty((N, k), torch.int32), \
        empty((N,), f32)
    # The scratch sizes follow k: the partials hold k entries a tile.
    scratch = (empty((N, Fp), dt),) if is_f32 else (
        empty((N, Fp), dt), empty((N, Hp), dt),
        empty((N * n_tiles,), f32), empty((N * n_tiles,), f32),
        empty((N * n_tiles * k,), f32),
        empty((N * n_tiles * k,), torch.int32),
        empty((3, N, Hp), dt))  # bf16 copies of h_att, h_lang, c*
    ptrs = [t.data_ptr() for t in (
        vhat_raw, h_att, h_lang, c_lang, c_star, pack.gate_w, pack.gate_b,
        pack.lang_wv, pack.lang_wha, pack.lang_wh, pack.lang_b, pack.wr_v,
        pack.wr_ha, pack.wr_hl, pack.wr_c, pack.br, head_w, head_b, h_out,
        c_out, vals, idx, lse, *scratch)]
    if is_f32:
        shares, _ = f32_head_plan(N, V, dev)
        err = lib.ck_lang_head_topk_f32(*ptrs, N, Hp, Fp, V, k, shares,
                                        dev.index or 0, _stream(dev))
    else:
        err = lib.ck_lang_head_topk(*ptrs, N, Hp, Fp, V, k, dev.index or 0,
                                    _stream(dev))
    if err:
        raise RuntimeError(
            "ck_lang_head_topk launch failed: "
            f"{lib.ck_wholestep_error_string(err).decode()} ({err})")
    return h_out, c_out, vals, idx, lse


def fused_lang_head_topk(pack: CellPack, vhat_raw, h_att2, c_star, h_lang,
                         c_lang, head_w, head_b, *, k: int):
    """The lang cell and the vocab head (``ops/wholestep.py::
    fused_lang_head_topk``): vhat_raw [N, Fp], h_att2 and c_star [N, Hp]
    from ``att_phase``; the pre-step h_lang, c_lang [N, H] fp32; head_w
    [H or Hp, V] in the compute dtype, head_b [V] fp32 (``prepad_head``).
    Returns (h_lang', c_lang' [N, H], vals [N, k] fp32, idx [N, k] int32,
    lse [N] fp32). CUDA tensors: ``csrc/wholestep.cu::ck_lang_head_topk``
    (one cooperative launch; fp32 pack: ``ck_lang_head_topk_f32``, three
    launches, the last the fp32 sweep of ``csrc/head_sm90.cuh``), counted in ``fused_lang_head_topk.launches``; CPU tensors:
    ``reference_lang_head_topk``."""
    if vhat_raw.device.type == "cpu":
        return reference_lang_head_topk(pack, vhat_raw, h_att2, c_star,
                                        h_lang, c_lang, head_w, head_b, k=k)
    H = h_lang.shape[1]
    h_lang, c_lang, head_w = _padded(pack, h_lang, c_lang, head_w)
    h2, c2, vals, idx, lse = _lang_head_kernel(
        pack, vhat_raw, h_att2, h_lang, c_lang, c_star, head_w, head_b, k)
    fused_lang_head_topk.launches += 1
    return h2[:, :H], c2[:, :H], vals, idx, lse


fused_lang_head_topk.launches = 0


def fused_step_topk(pack: CellPack, h_att, c_att, h_lang, c_lang, emb,
                    head_w, head_b, *, k: int):
    """One whole EditNet beam step (``ops/wholestep.py::fused_step_topk``):
    ``att_phase``, then ``fused_lang_head_topk``. State [N, H] fp32, emb
    [N, E] fp32. Returns (h_att', c_att', h_lang', c_lang' [N, H], vals,
    idx, lse)."""
    H = h_att.shape[1]
    h_att2, c_att2, vhat_raw, c_star = att_phase(pack, h_att, c_att, h_lang,
                                                 emb)
    h2, c2, vals, idx, lse = fused_lang_head_topk(
        pack, vhat_raw, h_att2, c_star, h_lang, c_lang, head_w, head_b, k=k)
    if pack.hp != H:
        h_att2, c_att2 = h_att2[:, :H], c_att2[:, :H]
    return h_att2, c_att2, h2, c2, vals, idx, lse
