"""Fused LSTM and Copy-LSTM cells (``captionkit.ops.lstm``; the kernels are
``csrc/lstm.cu``), the cells ``nn.dispatch`` returns with
``use_pallas=True``.

``fused_lstm_cell(params, x, h, c, *, compute_dtype, packed=None)`` and
``fused_copy_lstm_cell(params, x, h, c, c_star, *, compute_dtype,
packed=None)`` are drop-ins for ``nn.cells.lstm_cell`` and
``nn.cells.copy_lstm_cell``: the same arguments (``packed`` is the plain
cells' precomputed weight, ``pack_lstm`` / ``pack_copy_lstm``), the same
(h', c') in fp32. On a CUDA tensor a wrapper launches its kernel (one
launch, counted in ``<wrapper>.launches``) or raises: ``compute_dtype=
bfloat16`` runs the sm90 kernel (``csrc/sm90_cell.cuh``), ``float32`` its
fp32 instance (``csrc/cell_common.cuh``'s fp32 tile: fp32 products on the
CUDA cores, not TF32). On a CPU tensor it
runs its plain version, ``reference_lstm_cell`` /
``reference_copy_lstm_cell``, which repeats the kernel's arithmetic on the
same padded operands: products of operands rounded to the compute dtype
with fp32 sums, gate math in fp32; for the Copy-LSTM the c* operand feeds
only the copy gate.

The weights are packed gate-major, [x | h] rows by 4Hp columns (i|f|g|o
blocks of Hp) and, for the copy gate, [x | h | c*] rows by Hp columns,
with D and H padded to the kernel's 32-wide tile (zeros; padded hidden
columns stay exactly 0 through the update). That is the reference layout
itself when D and H are multiples of 32, so the plain cells' ``packed``
weights serve as they are; otherwise the padded pack is built once per
parameter object and compute dtype (``params.cache``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from captionkit_torch.kernels.megastep import (
    _check,
    _pad_gates,
    _pad_to,
    _qpad,
    _round_up,
    _stream,
    _vec,
    _wpad,
)
from captionkit_torch.nn.cells import (
    CopyLSTMParams,
    LSTMParams,
    lstm_gates,
    mm,
)

TILE = 32  # csrc/lstm.cu pads D and H to this (its hidden-column tile)


@dataclass
class LSTMCellPack:
    """Gate-major weights of one LSTM cell at the kernel's widths."""

    w: torch.Tensor  # [Dp + Hp, 4Hp] compute dtype: x rows | h rows
    b: torch.Tensor  # [4Hp] fp32
    wr: Optional[torch.Tensor] = None  # Copy-LSTM: [Dp + 2Hp, Hp] x|h|c*
    br: Optional[torch.Tensor] = None  # Copy-LSTM: [Hp] fp32

    @property
    def hp(self) -> int:
        return self.b.shape[0] // 4

    @property
    def dp(self) -> int:
        return self.w.shape[0] - self.hp

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype


def _aligned(D: int, H: int) -> bool:
    return D % TILE == 0 and H % TILE == 0


def lstm_cell_pack(params: LSTMParams, dt: torch.dtype,
                   packed: Optional[torch.Tensor] = None) -> LSTMCellPack:
    """The kernel's weights for ``params`` in ``dt``: the plain cell's
    ``packed`` [D + H, 4H] itself when D and H are multiples of 32, else
    (or without ``packed``) a pack built once per parameter object and
    dtype."""
    D, H = params.wx.shape[0], params.wh.shape[0]
    if packed is not None and _aligned(D, H):
        return LSTMCellPack(w=packed, b=params.b.float().contiguous())
    key = ("kernel_pack", dt)
    pack = params.cache.get(key)
    if pack is None:
        Dp, Hp = _round_up(D, TILE), _round_up(H, TILE)
        pack = LSTMCellPack(
            w=torch.cat([_wpad(params.wx, Dp, Hp, dt),
                         _wpad(params.wh, Hp, Hp, dt)]),
            b=_pad_gates(params.b.float(), Hp).contiguous())
        params.cache[key] = pack
    return pack


def copy_lstm_cell_pack(params: CopyLSTMParams, dt: torch.dtype,
                        packed=None) -> LSTMCellPack:
    """The Copy-LSTM's kernel weights: ``packed`` (``pack_copy_lstm``'s
    pair) itself when D and H are multiples of 32, else (or without it) a
    pack built once per parameter object and dtype."""
    base = params.base
    D, H = base.wx.shape[0], base.wh.shape[0]
    if packed is not None and _aligned(D, H):
        w, wr = packed
        return LSTMCellPack(w=w, b=base.b.float().contiguous(), wr=wr,
                            br=params.br.float().contiguous())
    key = ("kernel_pack", dt)
    pack = params.cache.get(key)
    if pack is None:
        Dp, Hp = _round_up(D, TILE), _round_up(H, TILE)
        pack = LSTMCellPack(
            w=torch.cat([_wpad(base.wx, Dp, Hp, dt),
                         _wpad(base.wh, Hp, Hp, dt)]),
            b=_pad_gates(base.b.float(), Hp).contiguous(),
            wr=torch.cat([_qpad(params.wrx, Dp, Hp, dt),
                          _qpad(params.wrh, Hp, Hp, dt),
                          _qpad(params.wrc, Hp, Hp, dt)]),
            br=_vec(params.br, Hp))
        params.cache[key] = pack
    return pack


# --------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic in PyTorch, on the padded pack)
# --------------------------------------------------------------------------


def _unpad(t: torch.Tensor, H: int) -> torch.Tensor:
    return t[:, :H].contiguous() if t.shape[1] != H else t


def reference_lstm_cell(params: LSTMParams, x, h, c, *,
                        compute_dtype: torch.dtype = torch.float32,
                        packed: Optional[torch.Tensor] = None):
    """The kernel's arithmetic on the same padded pack: (h', c') [N, H]
    fp32. The wrapper's signature."""
    dt = compute_dtype
    pack = lstm_cell_pack(params, dt, packed)
    Dp, Hp = pack.dp, pack.hp
    xh = torch.cat([_pad_to(x, 1, Dp).to(dt), _pad_to(h, 1, Hp).to(dt)],
                   dim=1)
    h2, c2 = lstm_gates(mm(xh, pack.w, dt) + pack.b,
                        _pad_to(c.float(), 1, Hp))
    H = params.wh.shape[0]
    return _unpad(h2, H), _unpad(c2, H)


def reference_copy_lstm_cell(params: CopyLSTMParams, x, h, c, c_star, *,
                             compute_dtype: torch.dtype = torch.float32,
                             packed=None):
    """The kernel's arithmetic on the same padded pack: (h', c') [N, H]
    fp32; c* feeds only the copy gate (and the blend, in fp32). The
    wrapper's signature."""
    dt = compute_dtype
    pack = copy_lstm_cell_pack(params, dt, packed)
    Dp, Hp = pack.dp, pack.hp
    c, c_star = _pad_to(c.float(), 1, Hp), _pad_to(c_star.float(), 1, Hp)
    xh = torch.cat([_pad_to(x, 1, Dp).to(dt), _pad_to(h, 1, Hp).to(dt)],
                   dim=1)
    z = mm(xh, pack.w, dt) + pack.b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_gen = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    xhc = torch.cat([xh, c_star.to(dt)], dim=1)
    r = torch.sigmoid(mm(xhc, pack.wr, dt) + pack.br)
    c_new = r * c_star + (1.0 - r) * c_gen
    H = params.base.wh.shape[0]
    return (_unpad(torch.sigmoid(o) * torch.tanh(c_new), H),
            _unpad(c_new, H))


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from captionkit_torch.kernels import build

        lib = build.load("lstm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ck_lstm_cell.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.ck_copy_lstm_cell.argtypes = [p] * 13 + [i] * 6 + [p]
        lib.ck_lstm_cell_f32.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.ck_copy_lstm_cell_f32.argtypes = [p] * 13 + [i] * 4 + [p]
        for name in ("ck_lstm_cell", "ck_copy_lstm_cell", "ck_lstm_cell_f32",
                     "ck_copy_lstm_cell_f32", "ck_lstm_tile"):
            getattr(lib, name).restype = i
        lib.ck_lstm_tile.argtypes = []
        lib.ck_lstm_error_string.argtypes = [i]
        lib.ck_lstm_error_string.restype = ctypes.c_char_p
        if lib.ck_lstm_tile() != TILE:
            raise RuntimeError("csrc/lstm.cu and kernels/lstm.py disagree "
                               "on the tile width")
        _LIB = lib
    return _LIB


def _run(fn_name: str, args) -> None:
    lib = _library()
    err = getattr(lib, fn_name)(*args)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.ck_lstm_error_string(err).decode()} "
                           f"({err})")


def _operand(t: torch.Tensor, width: int, dt: torch.dtype
             ) -> tuple[torch.Tensor, int]:
    """A product operand as the kernel reads it (fp32 or bf16, padded to
    ``width`` columns, contiguous; fp32 under an fp32 compute dtype, which
    holds bf16 exactly) and its fp32 flag."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the cell kernels take fp32 or bf16 inputs, got "
                        f"{t.dtype}")
    if dt == torch.float32:
        t = t.float()
    t = _pad_to(t, 1, width).contiguous()
    return t, int(t.dtype == torch.float32)


def _state(t: torch.Tensor, width: int) -> torch.Tensor:
    return _pad_to(t.float(), 1, width).contiguous()


def _kernel_dtype(compute_dtype) -> str:
    """The C entry points' suffix for the compute dtype: the sm90 kernel
    (bf16) or its fp32 instance."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("the CUDA cell kernels compute in bfloat16 or "
                        f"float32; got compute_dtype={compute_dtype}")
    return "_f32" if compute_dtype == torch.float32 else ""


def fused_lstm_cell(params: LSTMParams, x, h, c, *,
                    compute_dtype: torch.dtype = torch.float32,
                    packed: Optional[torch.Tensor] = None):
    """One LSTM step (``ops/lstm.py::fused_lstm_cell``): (h', c') [N, H]
    fp32. CUDA tensors: ``csrc/lstm.cu::ck_lstm_cell`` (1 launch), counted
    in ``fused_lstm_cell.launches``; CPU tensors: ``reference_lstm_cell``."""
    dt = compute_dtype
    if x.device.type == "cpu":
        return reference_lstm_cell(params, x, h, c, compute_dtype=dt,
                                   packed=packed)
    suffix = _kernel_dtype(dt)
    H = params.wh.shape[0]
    pack = lstm_cell_pack(params, dt, packed)
    dev, f32 = x.device, torch.float32
    N = x.shape[0]
    Dp, Hp = pack.dp, pack.hp
    xk, x_f32 = _operand(x, Dp, dt)
    hk, h_f32 = _operand(h, Hp, dt)
    ck = _state(c, Hp)
    w_x, w_h = pack.w[:Dp], pack.w[Dp:]
    _check(dev, x=(xk, xk.dtype, (N, Dp)), h=(hk, hk.dtype, (N, Hp)),
           c=(ck, f32, (N, Hp)), w_x=(w_x, dt, (Dp, 4 * Hp)),
           w_h=(w_h, dt, (Hp, 4 * Hp)), b=(pack.b, f32, (4 * Hp,)))
    h_out = torch.empty((N, Hp), dtype=f32, device=dev)
    c_out = torch.empty((N, Hp), dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (xk, hk, ck, w_x, w_h, pack.b, h_out,
                                   c_out)]
    flags = [] if suffix else [x_f32, h_f32]
    _run("ck_lstm_cell" + suffix, ptrs + [N, Dp, Hp, *flags,
                                          dev.index or 0, _stream(dev)])
    fused_lstm_cell.launches += 1
    return _unpad(h_out, H), _unpad(c_out, H)


def fused_copy_lstm_cell(params: CopyLSTMParams, x, h, c, c_star, *,
                         compute_dtype: torch.dtype = torch.float32,
                         packed=None):
    """One Copy-LSTM step (``ops/lstm.py::fused_copy_lstm_cell``): (h', c')
    [N, H] fp32. CUDA tensors: ``csrc/lstm.cu::ck_copy_lstm_cell`` (1
    launch), counted in ``fused_copy_lstm_cell.launches``; CPU tensors:
    ``reference_copy_lstm_cell``."""
    dt = compute_dtype
    if x.device.type == "cpu":
        return reference_copy_lstm_cell(params, x, h, c, c_star,
                                        compute_dtype=dt, packed=packed)
    suffix = _kernel_dtype(dt)
    H = params.base.wh.shape[0]
    pack = copy_lstm_cell_pack(params, dt, packed)
    dev, f32 = x.device, torch.float32
    N = x.shape[0]
    Dp, Hp = pack.dp, pack.hp
    xk, x_f32 = _operand(x, Dp, dt)
    hk, h_f32 = _operand(h, Hp, dt)
    ck, csk = _state(c, Hp), _state(c_star, Hp)
    w_x, w_h = pack.w[:Dp], pack.w[Dp:]
    w_rx, w_rh, w_rc = pack.wr[:Dp], pack.wr[Dp:Dp + Hp], pack.wr[Dp + Hp:]
    _check(dev, x=(xk, xk.dtype, (N, Dp)), h=(hk, hk.dtype, (N, Hp)),
           c=(ck, f32, (N, Hp)), c_star=(csk, f32, (N, Hp)),
           w_x=(w_x, dt, (Dp, 4 * Hp)), w_h=(w_h, dt, (Hp, 4 * Hp)),
           w_rx=(w_rx, dt, (Dp, Hp)), w_rh=(w_rh, dt, (Hp, Hp)),
           w_rc=(w_rc, dt, (Hp, Hp)), b=(pack.b, f32, (4 * Hp,)),
           br=(pack.br, f32, (Hp,)))
    h_out = torch.empty((N, Hp), dtype=f32, device=dev)
    c_out = torch.empty((N, Hp), dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (xk, hk, ck, csk, w_x, w_h, w_rx, w_rh,
                                   w_rc, pack.b, pack.br, h_out, c_out)]
    flags = [] if suffix else [x_f32, h_f32]
    _run("ck_copy_lstm_cell" + suffix, ptrs + [N, Dp, Hp, *flags,
                                               dev.index or 0, _stream(dev)])
    fused_copy_lstm_cell.launches += 1
    return _unpad(h_out, H), _unpad(c_out, H)


fused_lstm_cell.launches = 0
fused_copy_lstm_cell.launches = 0
