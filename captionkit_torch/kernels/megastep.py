"""Fused decode-step cells of EditNet and DCNet (``captionkit.ops.megastep``;
the kernels are ``csrc/megastep.cu``). Selected by ``cell_impl="pallas"``
for beam decode.

EditNet's step up to the vocab head is two kernels around two grouped
products:

1. ``att_cell`` — the att-LSTM from split products over [emb | h_lang |
   h_att] plus the hoisted ``zvb``, then the visual and SCMA additive
   scores and softmaxes (α over the regions, β over the caption, masked);
2. α→v̂ and β→c*, grouped per image (``nn.cells.bmm``; the reference keeps
   them outside Pallas too);
3. ``lang_cell`` — the visual context gate, the Copy-LSTM base gates and
   copy gate from split products over [v̂ | h_att | h_lang (| c*)], and
   the c*/c_gen blend.

DCNet's step is ``dcnet_score`` (ω over the caption), the grouped ω→ctx
product and ``dcnet_cell`` (context gate, then the decoder LSTM over
[emb | part | h]).

Each wrapper launches its CUDA kernels for CUDA tensors (fp32 activations;
a bf16 pack, or an fp32 one under ``compute_dtype="float32"``, which runs
the kernels' fp32 instances: fp32 products on the CUDA cores, not TF32)
or raises, and runs its plain PyTorch version,
``reference_<name>``, for CPU tensors; ``<wrapper>.launches`` counts its
calls that launched. The plain versions repeat the kernels' arithmetic on
the same pack: products of operands rounded to the compute dtype with
fp32 results, gate math and softmax in fp32, the mask ``NEG_INF``,
α/β/ω written in the compute dtype.

The pack (``prepare_cell_pack``, ``prepare_dcnet_cell_pack``) pads every
feature width (E, H, A, F) to a multiple of 128 with zeros, gate blocks
padded one by one so that i|f|g|o stay at multiples of the padded H, as
the reference does; padded hidden columns stay exactly 0 through the
LSTM update. Attention positions are not padded. The weights are padded
and rounded once per parameter object and compute dtype (kept in
``params.cache``), each cell's split-operand weights stacked by rows into
one tensor; the per-image context and ``zvb`` once per batch.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from captionkit_torch.nn.cells import bmm, lstm_gates, mm
from captionkit_torch.nn.masking import NEG_INF

LANE = 128  # feature widths are padded to the kernels' 128-column tile
GATE_TILE = 32  # hidden columns per block of the gated kernels


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad_to(x: torch.Tensor, dim: int, target: int) -> torch.Tensor:
    """Zero-pad ``dim`` up to ``target``; ``x`` itself when it is there."""
    pad = target - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.dim() - dim % x.dim())
    widths[-1] = pad
    return F.pad(x, widths)


def _pad_gates(w: torch.Tensor, hp: int) -> torch.Tensor:
    """[..., 4H] -> [..., 4Hp], each gate block padded on its own."""
    h = w.shape[-1] // 4
    if h == hp:
        return w
    w4 = w.reshape(*w.shape[:-1], 4, h)
    return _pad_to(w4, w4.dim() - 1, hp).reshape(*w.shape[:-1], 4 * hp)


def _wpad(w, rows, hp, dt):  # [in, 4H] -> [rows, 4Hp] in dt
    return _pad_to(_pad_gates(w, hp), 0, rows).to(dt).contiguous()


def _qpad(w, rows, cols, dt):  # [in, out] -> [rows, cols] in dt
    return _pad_to(_pad_to(w, 1, cols), 0, rows).to(dt).contiguous()


def _vec(v, n):  # [n0] -> [n] fp32
    return _pad_to(v.float(), 0, n).contiguous()


def _ctx(x, width, dt):  # per-image context [B, P, W] -> [B, P, width] dt
    return _pad_to(x, 2, width).to(dt).contiguous()


def _cdt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32


# --------------------------------------------------------------------------
# Packs
# --------------------------------------------------------------------------


@dataclass
class CellPack:
    """EditNet's padded weights and per-image context for one batch."""

    # att_cell weights (compute dtype unless noted)
    w_att: torch.Tensor  # [Ep + 2Hp, 4Hp]  att-LSTM rows emb | h_lang | h_att
    wq: torch.Tensor  # [Hp, 2Ap]  visual | SCMA query products
    vis_v: torch.Tensor  # [Ap] fp32
    vis_b: torch.Tensor  # [Ap] fp32
    scma_v: torch.Tensor  # [Ap] fp32
    scma_b: torch.Tensor  # [Ap] fp32
    # lang_cell weights
    gate_w: torch.Tensor  # [Hp, Fp]
    gate_b: torch.Tensor  # [Fp] fp32
    lang_w: torch.Tensor  # [Fp + 2Hp, 4Hp]  Copy-LSTM base rows
    #                       v_hat | h_att | h_lang
    lang_b: torch.Tensor  # [4Hp] fp32
    wr: torch.Tensor  # [Fp + 3Hp, Hp]  copy gate rows v_hat | h_att |
    #                   h_lang | c*
    br: torch.Tensor  # [Hp] fp32
    # per-image context (compute dtype unless noted)
    vis_keys: torch.Tensor  # [B, R, Ap]
    features: torch.Tensor  # [B, R, Fp]
    scma_keys: torch.Tensor  # [B, T, Ap]
    enc_cs: torch.Tensor  # [B, T, Hp]
    scma_mask: torch.Tensor  # [B, T] fp32, 1 = attendable
    zvb: torch.Tensor  # [N, 4Hp] fp32: hoisted v_mean product + bias

    # Each cell's weights are one row-stacked tensor, so the plain version
    # runs one product on it; the kernels take these row-range views of
    # it, one per split operand (no copy).
    @property
    def hp(self) -> int:
        return self.wr.shape[1]

    @property
    def w_emb(self) -> torch.Tensor:
        return self.w_att[:-2 * self.hp]

    @property
    def w_hl(self) -> torch.Tensor:
        return self.w_att[-2 * self.hp:-self.hp]

    @property
    def w_ha(self) -> torch.Tensor:
        return self.w_att[-self.hp:]

    @property
    def lang_wv(self) -> torch.Tensor:
        return self.lang_w[:-2 * self.hp]

    @property
    def lang_wha(self) -> torch.Tensor:
        return self.lang_w[-2 * self.hp:-self.hp]

    @property
    def lang_wh(self) -> torch.Tensor:
        return self.lang_w[-self.hp:]

    @property
    def wr_v(self) -> torch.Tensor:
        return self.wr[:-3 * self.hp]

    @property
    def wr_ha(self) -> torch.Tensor:
        return self.wr[-3 * self.hp:-2 * self.hp]

    @property
    def wr_hl(self) -> torch.Tensor:
        return self.wr[-2 * self.hp:-self.hp]

    @property
    def wr_c(self) -> torch.Tensor:
        return self.wr[-self.hp:]

    @property
    def dtype(self) -> torch.dtype:
        return self.w_att.dtype


def _editnet_weights(params, cfg) -> dict:
    dt = _cdt(cfg)
    key = ("cell_pack", dt)
    w = params.cache.get(key)
    if w is not None:
        return w
    E, H, A, Fd = cfg.emb_dim, cfg.hidden_dim, cfg.att_dim, cfg.feat_dim
    Ep, Hp, Ap, Fp = (_round_up(d, LANE) for d in (E, H, A, Fd))
    wx = params.att_lstm.wx  # [E + F + H, 4H]
    lwx = params.lang_lstm.base.wx  # [F + H, 4H]
    ll = params.lang_lstm
    va, sa = params.vis_attention, params.scma
    w = {
        "w_att": torch.cat([_wpad(wx[:E], Ep, Hp, dt),
                            _wpad(wx[E + Fd:], Hp, Hp, dt),
                            _wpad(params.att_lstm.wh, Hp, Hp, dt)]),
        "wq": torch.cat([_qpad(va.w_q, Hp, Ap, dt),
                         _qpad(sa.w_q, Hp, Ap, dt)], dim=1).contiguous(),
        "vis_v": _vec(va.v, Ap), "vis_b": _vec(va.b, Ap),
        "scma_v": _vec(sa.v, Ap), "scma_b": _vec(sa.b, Ap),
        "gate_w": _qpad(params.vis_gate_w, Hp, Fp, dt),
        "gate_b": _vec(params.vis_gate_b, Fp),
        "lang_w": torch.cat([_wpad(lwx[:Fd], Fp, Hp, dt),
                             _wpad(lwx[Fd:], Hp, Hp, dt),
                             _wpad(ll.base.wh, Hp, Hp, dt)]),
        "lang_b": _pad_gates(ll.base.b.float(), Hp).contiguous(),
        "wr": torch.cat([_qpad(ll.wrx[:Fd], Fp, Hp, dt),
                         _qpad(ll.wrx[Fd:], Hp, Hp, dt),
                         _qpad(ll.wrh, Hp, Hp, dt),
                         _qpad(ll.wrc, Hp, Hp, dt)]),
        "br": _vec(ll.br, Hp),
    }
    params.cache[key] = w
    return w


def prepare_cell_pack(params, cfg, ctx) -> CellPack:
    """EditNet's pack for one decode batch. ``ctx`` is the beam-expanded
    EditNetContext: ``att_zv`` per row, keys and values per image."""
    dt = _cdt(cfg)
    w = _editnet_weights(params, cfg)
    Hp, Fp = w["wr"].shape[1], w["gate_w"].shape[1]
    Ap = w["vis_v"].shape[0]
    zvb = _pad_gates(ctx.att_zv.float() + params.att_lstm.b, Hp)
    return CellPack(
        **w,
        vis_keys=_ctx(ctx.vis_keys, Ap, dt),
        features=_ctx(ctx.features, Fp, dt),
        scma_keys=_ctx(ctx.scma_keys, Ap, dt),
        enc_cs=_ctx(ctx.enc_cs, Hp, dt),
        scma_mask=ctx.mask.float().contiguous(),
        zvb=zvb.contiguous(),
    )


@dataclass
class DCNetCellPack:
    """DCNet's padded weights and per-image context (textual config)."""

    att_wq: torch.Tensor  # [Hp, Ap]
    att_v: torch.Tensor  # [Ap] fp32
    att_b: torch.Tensor  # [Ap] fp32
    gate_w: torch.Tensor  # [Hp, Hp]
    gate_b: torch.Tensor  # [Hp] fp32
    dec_w: torch.Tensor  # [Ep + 2Hp, 4Hp] decoder rows emb | part | h
    b: torch.Tensor  # [4Hp] fp32
    att_keys: torch.Tensor  # [B, T, Ap]
    enc_hs: torch.Tensor  # [B, T, Hp]
    mask: torch.Tensor  # [B, T] fp32, 1 = attendable

    # Row-range views of ``dec_w``, one per split operand of the kernel.
    @property
    def hp(self) -> int:
        return self.gate_w.shape[0]

    @property
    def w_emb(self) -> torch.Tensor:
        return self.dec_w[:-2 * self.hp]

    @property
    def w_part(self) -> torch.Tensor:
        return self.dec_w[-2 * self.hp:-self.hp]

    @property
    def w_h(self) -> torch.Tensor:
        return self.dec_w[-self.hp:]

    @property
    def dtype(self) -> torch.dtype:
        return self.dec_w.dtype


def prepare_dcnet_cell_pack(params, cfg, ctx) -> DCNetCellPack:
    dt = _cdt(cfg)
    key = ("cell_pack", dt)
    w = params.cache.get(key)
    if w is None:
        E, H, A = cfg.emb_dim, cfg.hidden_dim, cfg.att_dim
        Ep, Hp, Ap = (_round_up(d, LANE) for d in (E, H, A))
        dec = params.decoder
        w = {
            "att_wq": _qpad(params.attention.w_q, Hp, Ap, dt),
            "att_v": _vec(params.attention.v, Ap),
            "att_b": _vec(params.attention.b, Ap),
            "gate_w": _qpad(params.gate_w, Hp, Hp, dt),
            "gate_b": _vec(params.gate_b, Hp),
            "dec_w": torch.cat([_wpad(dec.wx[:E], Ep, Hp, dt),
                                _wpad(dec.wx[E:], Hp, Hp, dt),
                                _wpad(dec.wh, Hp, Hp, dt)]),
            "b": _pad_gates(dec.b.float(), Hp).contiguous(),
        }
        params.cache[key] = w
    Hp, Ap = w["gate_w"].shape[0], w["att_v"].shape[0]
    return DCNetCellPack(
        **w,
        att_keys=_ctx(ctx.att_keys, Ap, dt),
        enc_hs=_ctx(ctx.enc_hs, Hp, dt),
        mask=ctx.mask.float().contiguous(),
    )


# --------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic in PyTorch)
# --------------------------------------------------------------------------


def _scores(q, b, v, keys, valid=None):
    """Grouped additive scores + masked softmax: q [N, Ap] fp32 against
    per-image keys [B, P, Ap]; valid [B, P] bool, or None when every
    position is. Returns [N, P] fp32."""
    B, P, A = keys.shape
    K = q.shape[0] // B
    e = torch.tanh(keys.float()[:, None] + q.reshape(B, K, 1, A) + b)
    s = e @ v  # [B, K, P]
    if valid is not None:
        s = torch.where(valid[:, None, :], s, NEG_INF)
    return torch.softmax(s, dim=-1).reshape(B * K, P)


def reference_att_cell(pack: CellPack, emb, h_att, c_att, h_lang):
    """(h_att' [N, Hp] fp32, c_att' [N, Hp] fp32, α [N, R], β [N, T]) in
    the pack's dtype; inputs fp32, padded to Ep / Hp."""
    dt = pack.dtype
    x = torch.cat([emb, h_lang, h_att], dim=1)
    h, c = lstm_gates(mm(x, pack.w_att, dt) + pack.zvb, c_att)
    Ap = pack.vis_v.shape[0]
    q = mm(h, pack.wq, dt)
    # Every region is attendable (the visual attention has no mask).
    alpha = _scores(q[:, :Ap], pack.vis_b, pack.vis_v, pack.vis_keys)
    beta = _scores(q[:, Ap:], pack.scma_b, pack.scma_v, pack.scma_keys,
                   pack.scma_mask > 0)
    return h, c, alpha.to(dt), beta.to(dt)


def reference_lang_cell(pack: CellPack, vhat_raw, h_att, h_lang, c_lang,
                        c_star):
    """(h_lang' [N, Hp], c_lang' [N, Hp]) fp32; vhat_raw [N, Fp] fp32 is
    rounded to the compute dtype first, as the reference rounds it."""
    dt = pack.dtype
    gate = torch.sigmoid(mm(h_att, pack.gate_w, dt) + pack.gate_b)
    v_hat = (gate * vhat_raw.to(dt).float()).to(dt).float()
    xh = torch.cat([v_hat, h_att, h_lang], dim=1)
    z = mm(xh, pack.lang_w, dt) + pack.lang_b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_gen = torch.sigmoid(f) * c_lang + torch.sigmoid(i) * torch.tanh(g)
    xhc = torch.cat([xh, c_star], dim=1)
    r = torch.sigmoid(mm(xhc, pack.wr, dt) + pack.br)
    c_new = r * c_star + (1.0 - r) * c_gen
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def reference_dcnet_score(pack: DCNetCellPack, h):
    """ω [N, T] in the pack's dtype from h [N, Hp] fp32."""
    dt = pack.dtype
    q = mm(h, pack.att_wq, dt)
    return _scores(q, pack.att_b, pack.att_v, pack.att_keys,
                   pack.mask > 0).to(dt)


def reference_dcnet_cell(pack: DCNetCellPack, emb, ctx, h, c, part=None):
    """(h' [N, Hp], c' [N, Hp]) fp32 from emb [N, Ep], the ω-weighted
    context ctx [N, Hp] and the state, all fp32. The gated context is
    rounded once, after the multiply (ctx is not rounded first); ``part``,
    if given ([N, Hp] in the pack's dtype), receives it."""
    dt = pack.dtype
    gate = torch.sigmoid(mm(h, pack.gate_w, dt) + pack.gate_b)
    gated = (gate * ctx).to(dt)
    if part is not None:
        part.copy_(gated)
    x = torch.cat([emb, gated.float(), h], dim=1)
    return lstm_gates(mm(x, pack.dec_w, dt) + pack.b, c)


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ck_att_cell.argtypes = [p] * 22 + [i] * 9 + [p]
    lib.ck_lang_cell.argtypes = [p] * 20 + [i] * 5 + [p]
    lib.ck_dcnet_score.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.ck_dcnet_cell.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.ck_f32_split.argtypes = [i] * 4
    for name in ("ck_att_cell", "ck_lang_cell", "ck_dcnet_score",
                 "ck_dcnet_cell", "ck_megastep_gate_width",
                 "ck_megastep_plain_width", "ck_f32_split"):
        getattr(lib, name).restype = i
    lib.ck_megastep_gate_width.argtypes = []
    lib.ck_megastep_plain_width.argtypes = []
    lib.ck_megastep_error_string.argtypes = [i]
    lib.ck_megastep_error_string.restype = ctypes.c_char_p
    # The pack's padding is computed from these two constants.
    if (lib.ck_megastep_gate_width(), lib.ck_megastep_plain_width()) != \
            (GATE_TILE, LANE):
        raise RuntimeError("csrc/megastep.cu and kernels/megastep.py "
                           "disagree on the column tiles")


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built and bound megastep library, loaded once per process."""
    global _LIB
    if _LIB is None:
        from captionkit_torch.kernels import build

        lib = build.load("megastep")
        _bind(lib)
        _LIB = lib
    return _LIB


def _check(device, **tensors) -> None:
    """Each value is (tensor, dtype, shape): on ``device``, of that dtype
    and shape, contiguous and 16-byte aligned, or raise."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _run(lib, fn_name: str, args) -> None:
    err = getattr(lib, fn_name)(*args)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.ck_megastep_error_string(err).decode()} "
                           f"({err})")


@functools.lru_cache(maxsize=None)
def f32_split(rows: int, k: int, cols: int, index: int) -> int:
    """The K ranges (partials) of an fp32 query product of ``rows`` x
    ``k`` x ``cols`` on card ``index``: ``csrc/megastep.cu::ck_f32_split``
    (``cell_common.cuh::plain_split`` at the card's SM count), which the
    kernels take too; the planes of the product's scratch."""
    lib = _library()
    split = lib.ck_f32_split(rows, k, cols, index)
    if split < 1:
        raise RuntimeError(
            "ck_f32_split failed: "
            f"{lib.ck_megastep_error_string(-split).decode()} ({-split})")
    return split


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _rows(N, B):
    if B < 1 or N % B:
        raise ValueError(f"row count {N} not a multiple of image count {B}")


def _pack_dtype(pack) -> tuple[torch.dtype, int]:
    """The kernels' compute dtype, the pack's (bf16 or fp32), and the
    fp32 flag the C entry points take."""
    dt = pack.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the cell kernels take a bf16 or fp32 pack, got "
                        f"{dt}")
    return dt, int(dt == torch.float32)


def att_cell(pack: CellPack, emb, h_att, c_att, h_lang):
    """Kernel A (``att_phase``'s pallas_call): (h_att', c_att', α, β).
    CUDA tensors: ``csrc/megastep.cu::ck_att_cell`` (3 launches: the
    att-LSTM and the query product, bf16 on ``csrc/sm90_cell.cuh``, fp32 on
    ``cell_common.cuh``'s fp32 tile, then ``score_kernel`` over both
    heads), counted in ``att_cell.launches``; CPU tensors:
    ``reference_att_cell``."""
    if emb.device.type == "cpu":
        return reference_att_cell(pack, emb, h_att, c_att, h_lang)
    dev, f32 = emb.device, torch.float32
    dt, is_f32 = _pack_dtype(pack)
    N, Ep = emb.shape
    B, R, Ap = pack.vis_keys.shape
    T = pack.scma_keys.shape[1]
    Hp = pack.hp
    _rows(N, B)
    _check(dev, emb=(emb, f32, (N, Ep)), h_att=(h_att, f32, (N, Hp)),
           c_att=(c_att, f32, (N, Hp)), h_lang=(h_lang, f32, (N, Hp)),
           zvb=(pack.zvb, f32, (N, 4 * Hp)),
           w_emb=(pack.w_emb, dt, (Ep, 4 * Hp)),
           w_hl=(pack.w_hl, dt, (Hp, 4 * Hp)),
           w_ha=(pack.w_ha, dt, (Hp, 4 * Hp)),
           wq=(pack.wq, dt, (Hp, 2 * Ap)),
           vis_b=(pack.vis_b, f32, (Ap,)), vis_v=(pack.vis_v, f32, (Ap,)),
           scma_b=(pack.scma_b, f32, (Ap,)),
           scma_v=(pack.scma_v, f32, (Ap,)),
           vis_keys=(pack.vis_keys, dt, (B, R, Ap)),
           scma_keys=(pack.scma_keys, dt, (B, T, Ap)),
           scma_mask=(pack.scma_mask, f32, (B, T)))
    lib = _library()
    h_out = torch.empty((N, Hp), dtype=f32, device=dev)
    c_out = torch.empty((N, Hp), dtype=f32, device=dev)
    alpha = torch.empty((N, R), dtype=dt, device=dev)
    beta = torch.empty((N, T), dtype=dt, device=dev)
    q = torch.empty((N, 2 * Ap), dtype=f32, device=dev)
    # bf16: h_att' rounded to bf16, the query product's operand.
    h16 = None if is_f32 else torch.empty((N, Hp), dtype=dt, device=dev)
    ptrs = [t.data_ptr() for t in (
        emb, h_att, c_att, h_lang, pack.zvb, pack.w_emb, pack.w_hl,
        pack.w_ha, pack.wq, pack.vis_b, pack.vis_v, pack.scma_b,
        pack.scma_v, pack.vis_keys, pack.scma_keys, pack.scma_mask, h_out,
        c_out, alpha, beta, q)]
    ptrs.append(None if h16 is None else h16.data_ptr())
    _run(lib, "ck_att_cell", ptrs + [N, B, Ep, Hp, Ap, R, T, is_f32,
                                     dev.index or 0, _stream(dev)])
    att_cell.launches += 1
    return h_out, c_out, alpha, beta


def lang_cell(pack: CellPack, vhat_raw, h_att, h_lang, c_lang, c_star):
    """Kernel B (``fused_step_hidden``'s pallas_call): (h_lang', c_lang').
    CUDA tensors: ``csrc/megastep.cu::ck_lang_cell`` (2 launches: bf16 on
    ``csrc/sm90_cell.cuh``, fp32 on ``cell_common.cuh``'s fp32 tile),
    counted in ``lang_cell.launches``; CPU tensors:
    ``reference_lang_cell``."""
    if vhat_raw.device.type == "cpu":
        return reference_lang_cell(pack, vhat_raw, h_att, h_lang, c_lang,
                                   c_star)
    dev, f32 = vhat_raw.device, torch.float32
    dt, is_f32 = _pack_dtype(pack)
    N, Fp = vhat_raw.shape
    Hp = pack.hp
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
           br=(pack.br, f32, (Hp,)))
    lib = _library()
    h_out = torch.empty((N, Hp), dtype=f32, device=dev)
    c_out = torch.empty((N, Hp), dtype=f32, device=dev)
    vhat = torch.empty((N, Fp), dtype=dt, device=dev)
    # bf16: the gate launch's bf16 copies of h_att, h_lang and c*.
    act16 = None if is_f32 else torch.empty((3, N, Hp), dtype=dt,
                                            device=dev)
    ptrs = [t.data_ptr() for t in (
        vhat_raw, h_att, h_lang, c_lang, c_star, pack.gate_w, pack.gate_b,
        pack.lang_wv, pack.lang_wha, pack.lang_wh, pack.lang_b, pack.wr_v,
        pack.wr_ha, pack.wr_hl, pack.wr_c, pack.br, h_out, c_out, vhat)]
    ptrs.append(None if act16 is None else act16.data_ptr())
    _run(lib, "ck_lang_cell", ptrs + [N, Hp, Fp, is_f32, dev.index or 0,
                                      _stream(dev)])
    lang_cell.launches += 1
    return h_out, c_out


def dcnet_score(pack: DCNetCellPack, h):
    """DCNet's score kernel: ω [N, T]. CUDA tensors:
    ``csrc/megastep.cu::ck_dcnet_score`` (2 launches: bf16, the query
    product on ``csrc/sm90_cell.cuh`` and ``score_kernel``; fp32,
    ``cell_common.cuh``'s fp32 tile split over K into ``f32_split``
    partials and ``score_kernel``'s fp32 instance), counted in
    ``dcnet_score.launches``; CPU tensors: ``reference_dcnet_score``."""
    if h.device.type == "cpu":
        return reference_dcnet_score(pack, h)
    dev, f32 = h.device, torch.float32
    dt, is_f32 = _pack_dtype(pack)
    N, Hp = h.shape
    B, T, Ap = pack.att_keys.shape
    _rows(N, B)
    _check(dev, h=(h, f32, (N, Hp)), att_wq=(pack.att_wq, dt, (Hp, Ap)),
           att_b=(pack.att_b, f32, (Ap,)), att_v=(pack.att_v, f32, (Ap,)),
           att_keys=(pack.att_keys, dt, (B, T, Ap)),
           mask=(pack.mask, f32, (B, T)))
    lib = _library()
    omega = torch.empty((N, T), dtype=dt, device=dev)
    # The query product's K-range partials (bf16: one).
    split = f32_split(N, Hp, Ap, dev.index or 0) if is_f32 else 1
    q = torch.empty((split, N, Ap), dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (h, pack.att_wq, pack.att_b, pack.att_v,
                                   pack.att_keys, pack.mask, omega, q)]
    _run(lib, "ck_dcnet_score", ptrs + [N, B, Hp, Ap, T, is_f32,
                                        dev.index or 0, _stream(dev)])
    dcnet_score.launches += 1
    return omega


def dcnet_cell(pack: DCNetCellPack, emb, ctx, h, c, part=None):
    """DCNet's LSTM kernel: (h', c'); ``part``, if given ([N, Hp] in the
    pack's dtype), receives the gated context. CUDA tensors:
    ``csrc/megastep.cu::ck_dcnet_cell`` (2 launches: bf16 on
    ``csrc/sm90_cell.cuh``, fp32 on ``cell_common.cuh``'s fp32 tile),
    counted in ``dcnet_cell.launches``; CPU tensors:
    ``reference_dcnet_cell``."""
    if emb.device.type == "cpu":
        return reference_dcnet_cell(pack, emb, ctx, h, c, part)
    dev, f32 = emb.device, torch.float32
    dt, is_f32 = _pack_dtype(pack)
    N, Ep = emb.shape
    Hp = pack.hp
    _check(dev, emb=(emb, f32, (N, Ep)), ctx=(ctx, f32, (N, Hp)),
           h=(h, f32, (N, Hp)), c=(c, f32, (N, Hp)),
           gate_w=(pack.gate_w, dt, (Hp, Hp)),
           gate_b=(pack.gate_b, f32, (Hp,)),
           w_emb=(pack.w_emb, dt, (Ep, 4 * Hp)),
           w_part=(pack.w_part, dt, (Hp, 4 * Hp)),
           w_h=(pack.w_h, dt, (Hp, 4 * Hp)), b=(pack.b, f32, (4 * Hp,)))
    lib = _library()
    h_out = torch.empty((N, Hp), dtype=f32, device=dev)
    c_out = torch.empty((N, Hp), dtype=f32, device=dev)
    if part is None:
        part = torch.empty((N, Hp), dtype=dt, device=dev)
    _check(dev, part=(part, dt, (N, Hp)))
    ptrs = [t.data_ptr() for t in (emb, ctx, h, c, pack.gate_w, pack.gate_b,
                                   pack.w_emb, pack.w_part, pack.w_h, pack.b,
                                   h_out, c_out, part)]
    _run(lib, "ck_dcnet_cell", ptrs + [N, Ep, Hp, is_f32, dev.index or 0,
                                       _stream(dev)])
    dcnet_cell.launches += 1
    return h_out, c_out


for _w in (att_cell, lang_cell, dcnet_score, dcnet_cell):
    _w.launches = 0


# --------------------------------------------------------------------------
# The fused steps
# --------------------------------------------------------------------------


def _grouped(weights, values):
    """Σ_p w[n, p] values[b(n), p] for rows n of image b(n): weights
    [N, P] in the compute dtype, values [B, P, D] -> [N, D] fp32."""
    B, P, D = values.shape
    K = weights.shape[0] // B
    out = bmm(weights.reshape(B, K, P), values, values.dtype)
    return out.reshape(B * K, D)


def att_phase(pack: CellPack, h_att, c_att, h_lang, emb):
    """``att_cell`` and the grouped α→v̂, β→c* products. State [N, H]
    fp32, emb [N, E] fp32. Returns Hp-padded (h_att', c_att', vhat_raw
    [N, Fp], c_star [N, Hp]), all fp32."""
    Hp, Ep = pack.hp, pack.w_emb.shape[0]
    hp = lambda x: _pad_to(x, 1, Hp)  # noqa: E731
    h2, c2, alpha, beta = att_cell(
        pack, _pad_to(emb, 1, Ep), hp(h_att), hp(c_att), hp(h_lang))
    return h2, c2, _grouped(alpha, pack.features), \
        _grouped(beta, pack.enc_cs)


def fused_step_hidden(pack: CellPack, h_att, c_att, h_lang, c_lang, emb):
    """One EditNet step up to the vocab head (``cell_impl="pallas"``,
    soft SCMA): (h_att', c_att', h_lang', c_lang'), each [N, H] fp32."""
    H = h_att.shape[1]
    Hp = pack.hp
    h_att2, c_att2, vhat_raw, c_star = att_phase(
        pack, h_att, c_att, h_lang, emb)
    h_lang2, c_lang2 = lang_cell(pack, vhat_raw, h_att2,
                                 _pad_to(h_lang, 1, Hp),
                                 _pad_to(c_lang, 1, Hp), c_star)
    unp = (lambda x: x[:, :H]) if Hp != H else (lambda x: x)
    return unp(h_att2), unp(c_att2), unp(h_lang2), unp(c_lang2)


def dcnet_fused_step_hidden(pack: DCNetCellPack, h, c, emb):
    """One DCNet step up to the vocab head (``cell_impl="pallas"``,
    textual config): (h', c'), each [N, H] fp32."""
    H = h.shape[1]
    Hp, Ep = pack.hp, pack.w_emb.shape[0]
    h_p, c_p = _pad_to(h, 1, Hp), _pad_to(c, 1, Hp)
    omega = dcnet_score(pack, h_p)
    ctx = _grouped(omega, pack.enc_hs)
    h2, c2 = dcnet_cell(pack, _pad_to(emb, 1, Ep), ctx, h_p, c_p)
    if Hp != H:
        return h2[:, :H], c2[:, :H]
    return h2, c2
