"""The score kernels on the CPU: a torch model of how the kernels of
``csrc/attention.cu`` (the dispatch attention, B6) and of
``csrc/megastep.cu``'s ``ck_dcnet_score`` and ``ck_att_cell`` split one
call, in bf16 and in fp32 (the kernels themselves run on a card:
test_torch_card.py), held against
``captionkit.ops.attention.fused_additive_attention``, the score kernel
of ``captionkit.ops.megastep.dcnet_fused_step_hidden`` and the att
kernel of ``captionkit.ops.megastep.att_phase`` in interpret mode.

The model follows the kernels step by step, in fp32:
- the query product of each 128-row x 128-column output tile (the
  ``sm90_cell.cuh`` GEMM), summed over 64-deep K stages of bf16 operands;
  B6's product split over K into the ranges ``query_split`` picks for an
  H100's 132 SMs, one partial each, which the context kernel adds in rank
  order;
- each score as one warp takes it: lane l sums tanh(k + q + b) v over its
  columns 8 l + 256 c + {0..7} in that order, and the 32 partial scores
  meet in the xor butterfly of ``warp_sum``; tanh as the kernels take it,
  1 - 2 / (2^(2 x log2 e) + 1) (B6), or tanh (``score_kernel``: the
  card's tanh.approx.f32 in bf16, not modelled);
- B6's ``context_kernel``: per row, the key stages of 14 KB (the valid
  prefix only; ``NEG_INF`` after it), the softmax over all P positions,
  then per 1024-column group the value stages (the valid prefix, or all P
  when it is empty), thread group g of G = 128 / (columns / 8) summing the
  positions g, g + G, ... of each stage, and the groups' partial sums
  added;
- ``score_kernel`` (``dcnet_score``'s one head; ``att_cell``'s visual
  head with no mask and SCMA head, after the query product of both): a
  query row against its image's keys, ``NEG_INF`` where the head's mask
  is not > 0, the row's softmax rounded to bf16 once.

The fp32 instances run the same kernels with fp32 keys and values: the
query product on ``cell_common.cuh``'s fp32 tile, split over K into the
ranges of whole 32-deep stages that ``plain_split`` picks for an H100
(partials added in rank order); a lane's score columns 4 l + 128 c +
{0..3}; the accurate tanh; B6's stages holding half the positions (14 KB
of 4-byte elements) and a thread's 8 context columns 4 col + {0..3} and
4 (col + n8) + {0..3} of its group; ω in fp32. (Which warp takes a
position, and whether its key comes from shared memory or L1, changes no
sum, so the model leaves it out; nor does the block of an image and a
head, whose warps each take one row.)

Bars (the port's dispatch and megastep tests): B6's weights within 1e-4
and its context within 1e-3 of the JAX kernel, and within max(1 bf16 ulp,
1e-4) and 1e-3 of the plain version; DCNet's ω and att_cell's α and β
within one bf16 ulp; fp32: everything within 1e-5 (the card's fp32 bar).
Each planted fault (a lane's partial score left out of the reduction, a
thread's 8 context columns written to the next slice, att_cell's visual
head given the SCMA mask) must fail them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from captionkit.nn.attention import AdditiveAttentionParams as JaxAttParams
from captionkit.ops import megastep as jax_megastep
from captionkit.ops.attention import fused_additive_attention as jax_attn

from captionkit_torch.kernels import attention as tattn
from captionkit_torch.kernels import megastep
from captionkit_torch.nn.attention import AdditiveAttentionParams
from captionkit_torch.nn.masking import NEG_INF

ROWS, COLS, K_STAGE = 128, 128, 64  # sm90_cell.cuh's tile and stage
F32_K_STAGE, F32_SPLIT_MAX = 32, 4  # cell_common.cuh's stage, MAX_OPS
F32_ATOL = 1e-5
H100_SMS = 132
STAGE_BYTES, VCOLS, CONSUMERS = 14 * 1024, 1024, 128  # context_kernel
FAULTS = ("lane_share_left_out", "slice_in_wrong_columns")
bf = torch.bfloat16


def _round_up(x, m):
    return (x + m - 1) // m * m


def _query(q, wq, split=1):
    """q [N, Qp] (rounded to bf16) times wq [Qp, Ap] bf16, fp32 sums: each
    128 x 128 output tile summed over 64-deep K stages, in ``split`` K
    ranges of Qp / split (a partial each, stages cut at the range's end),
    the partials added in rank order."""
    N, Qp = q.shape
    Ap = wq.shape[1]
    Kc = Qp // split
    a, w = q.to(bf).float(), wq.float()
    parts = torch.zeros((split, N, Ap))
    for c in range(split):
        for r0 in range(0, N, ROWS):
            for c0 in range(0, Ap, COLS):
                acc = torch.zeros((min(ROWS, N - r0), COLS))
                for k0 in range(c * Kc, (c + 1) * Kc, K_STAGE):
                    k1 = min(k0 + K_STAGE, (c + 1) * Kc)
                    acc += a[r0:r0 + ROWS, k0:k1] @ w[k0:k1, c0:c0 + COLS]
                parts[c, r0:r0 + ROWS, c0:c0 + COLS] = acc
    out = parts[0]
    for c in range(1, split):
        out = out + parts[c]
    return out


def _plain_split(tiles, steps, sms=H100_SMS):
    """``cell_common.cuh::plain_split``: the K ranges s <= 4 (and <= the
    stages) minimizing the waves of s tiles' CTAs times the stages of the
    longest range, the smallest on a tie."""
    best, cost = 1, -(-tiles // sms) * steps
    for s in range(2, min(F32_SPLIT_MAX, steps) + 1):
        c = -(-(tiles * s) // sms) * -(-steps // s)
        if c < cost:
            best, cost = s, c
    return best


def _query_f32(q, wq, split=None):
    """q [N, Qp] fp32 times wq [Qp, Ap] fp32 on the fp32 tile: ``split``
    K ranges of whole 32-deep stages (range c: stages [c S / split, (c + 1)
    S / split)), fp32 partials added in rank order; ``split`` None takes
    the H100's ``plain_split``."""
    N, Qp = q.shape
    S = Qp // F32_K_STAGE
    if split is None:
        split = _plain_split((wq.shape[1] // COLS) * -(-N // ROWS), S)
    out = None
    for c in range(split):
        k0 = S * c // split * F32_K_STAGE
        k1 = S * (c + 1) // split * F32_K_STAGE
        part = q[:, k0:k1] @ wq[k0:k1]
        out = part if out is None else out + part
    return out


def _tanh_ex2(x):
    """The kernels' tanh, 1 - 2 / (2^(2 x log2 e) + 1), in fp32."""
    return 1.0 - 2.0 / (torch.exp2(x * 2.88539008) + 1.0)


def _warp_score(terms, fault=None, vec=8):
    """The warp's sum of terms [..., A]: lane l's partial over columns
    vec l + 32 vec c + j (c, then j; vec 8 in bf16, 4 in fp32), then the
    xor butterfly; lane 0's total. ``lane_share_left_out``: lane 3's
    partial dropped."""
    A = terms.shape[-1]
    chunk = 32 * vec
    nc = -(-A // chunk)
    t = F.pad(terms, (0, chunk * nc - A)).reshape(*terms.shape[:-1], nc, 32,
                                                  vec)
    part = torch.zeros(terms.shape[:-1] + (32,))
    for c in range(nc):
        for j in range(vec):
            part = part + t[..., c, :, j]
    if fault == "lane_share_left_out":
        part[..., 3] = 0.0
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    return part[..., 0]


def _b6_model(q, wq, b, v, keys, values, nvalid, fault=None, split=None):
    """(ctx [B, V], w [B, P]) as the kernels compute them; q fp32 [B, Qp],
    wq [Qp, Ap], b, v fp32 [Ap], keys [B, P, Ap], values [B, P, V], nvalid
    [B]; wq, keys and values bf16, or fp32 (the fp32 instance); the query
    product in ``split`` K ranges (the wrapper's choice on an H100 when
    None). Also the number of value positions each row reads."""
    f32 = keys.dtype == torch.float32
    elem, vec = (4, 4) if f32 else (2, 8)
    if f32:
        qa = _query_f32(q, wq, split)
    else:
        if split is None:
            split = tattn.query_split(q.shape[0], wq.shape[1], H100_SMS)
        qa = _query(q, wq, split)
    tanh = torch.tanh if f32 else _tanh_ex2
    B, P, A = keys.shape
    V = values.shape[2]
    kc = STAGE_BYTES // (elem * A)
    ctx, w = torch.zeros((B, V)), torch.zeros((B, P))
    read = []
    for row in range(B):
        nk = max(0, min(int(nvalid[row]), P))
        nval = nk if nk > 0 else P
        s = torch.full((P,), NEG_INF)
        for p0 in range(0, nk, kc):
            k = keys[row, p0:min(nk, p0 + kc)].float()
            s[p0:p0 + k.shape[0]] = _warp_score(
                tanh(k + qa[row] + b) * v, fault, vec)
        w[row] = torch.softmax(s, dim=0)
        for c0 in range(0, V, VCOLS):
            cw = min(VCOLS, V - c0)
            pc = STAGE_BYTES // (elem * cw)
            n8 = cw // 8
            G = CONSUMERS // n8
            part = torch.zeros((G, cw))
            for p0 in range(0, nval, pc):
                for j in range(min(pc, nval - p0)):
                    part[j % G] += w[row, p0 + j] * \
                        values[row, p0 + j, c0:c0 + cw].float()
            out = part.sum(dim=0)
            if fault == "slice_in_wrong_columns" and cw >= 16:
                if f32:  # thread 0's columns 0..3, 4 n8 .. 4 n8 + 3
                    out[4:8] = out[0:4].clone()
                    out[4 * n8 + 4:4 * n8 + 8] = out[4 * n8:4 * n8 + 4].clone()
                else:
                    out[8:16] = out[0:8].clone()
            ctx[row, c0:c0 + cw] = out
        read.append(nval)
    return ctx, w, read


def _head_model(q, b, v, keys, mask, fault=None):
    """One head of ``score_kernel``: the weights [N, P] of rows q [N, Ap]
    fp32 against their images' keys [B, P, Ap] (bf16 or fp32), (key + q)
    + b as the kernel adds them, a row's scores as its warps take them
    (lane chunks of 8 bf16 or 4 fp32 columns, the butterfly), ``NEG_INF``
    where ``mask`` [B, P] is not > 0 (None: every position attends), the
    row's softmax rounded to the keys' dtype once. The tanh is the
    accurate one: the fp32 instances take tanhf; the bf16 ones take the
    card's tanh.approx.f32 (within 2^-11 relative), whose error the card
    tests hold against the bar and this model leaves out."""
    B = keys.shape[0]
    N = q.shape[0]
    img = torch.arange(N) // (N // B)
    e = torch.tanh(keys.float()[img] + q[:, None, :] + b) * v
    s = _warp_score(e, fault, 4 if keys.dtype == torch.float32 else 8)
    if mask is not None:
        s = torch.where(mask[img] > 0, s, NEG_INF)
    return torch.softmax(s, dim=-1).to(keys.dtype)


def _dcnet_model(h, wq, b, v, keys, mask, fault=None):
    """ω [N, T] as the kernels compute it: bf16, q = bf16(h) wq on the
    wgmma tile; fp32 (wq and keys fp32), q the fp32 tile's K-range
    partials added in rank order; then ``score_kernel``'s one head, ω in
    the keys' dtype."""
    f32 = keys.dtype == torch.float32
    q = _query_f32(h, wq) if f32 else _query(h, wq)
    return _head_model(q, b, v, keys, mask, fault)


def _ulp_close(got, want):
    """Within one bf16 ulp of the larger magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    return bool((np.abs(got - want) <= np.ldexp(1.0, e - 8)).all())


def _w_close(got, want):
    """max(1 bf16 ulp, 1e-4): the card's bar for the fp32 weights."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    bar = np.maximum(np.ldexp(1.0, e - 8), 1e-4)
    return bool((np.abs(got - want) <= bar).all())


def _lengths(pattern, B, P, rng):
    if pattern == "full":
        return np.full(B, P)
    if pattern == "zero_one_full":
        return np.array([(0, 1, P)[i % 3] for i in range(B)])
    return rng.integers(0, P + 1, B)


def _b6_case(B, P, A, V, Q, pattern, seed=7):
    rng = np.random.default_rng(seed)
    arrays = dict(
        w_enc=rng.uniform(-1, 1, (V, A)).astype(np.float32) * V ** -0.5,
        w_q=rng.uniform(-1, 1, (Q, A)).astype(np.float32) * Q ** -0.5,
        v=rng.uniform(-1, 1, (A,)).astype(np.float32) * A ** -0.5,
        b=rng.uniform(-0.1, 0.1, (A,)).astype(np.float32))
    values = rng.standard_normal((B, P, V)).astype(np.float32)
    keys = (rng.standard_normal((B, P, A)) * 0.5).astype(np.float32)
    query = rng.standard_normal((B, Q)).astype(np.float32)
    lengths = _lengths(pattern, B, P, rng)
    mask = np.arange(P)[None, :] < lengths[:, None]
    return arrays, keys, values, query, mask, lengths


def _b6_both(arrays, keys, values, query, mask, lengths, fault=None,
             split=None, dt=bf):
    """(JAX kernel (ctx, w), model (ctx, w, read), plain (ctx, w)) in the
    compute dtype ``dt`` (bf16 or fp32)."""
    jdt = jnp.bfloat16 if dt == bf else jnp.float32
    jp = JaxAttParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jk = jnp.asarray(keys).astype(jdt)
    jv = jnp.asarray(values).astype(jdt)
    j = jax_attn(jp, jk, jv, jnp.asarray(query), jnp.asarray(mask),
                 compute_dtype=jdt, interpret=True)
    tp = AdditiveAttentionParams(
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    B, P, A = keys.shape
    Q = query.shape[1]
    Qp, Ap = _round_up(Q, tattn.K_TILE), _round_up(A, 128)
    wq = F.pad(tp.w_q, (0, Ap - A, 0, Qp - Q)).to(dt)
    tk = F.pad(torch.from_numpy(keys), (0, Ap - A)).to(dt)
    tv = torch.from_numpy(values).to(dt)
    q = F.pad(torch.from_numpy(query), (0, Qp - Q))
    m = _b6_model(q, wq, F.pad(tp.b, (0, Ap - A)), F.pad(tp.v, (0, Ap - A)),
                  tk, tv, torch.from_numpy(lengths), fault, split)
    plain = tattn.reference_additive_attention(
        tp, tk[..., :A], tv, torch.from_numpy(query),
        torch.from_numpy(mask), compute_dtype=dt)
    return j, m, plain


def _b6_ok(j, m, plain, lengths):
    """The bars against the JAX kernel on rows with a valid position, and
    against the plain version on every row. (The JAX kernel pads P to a
    multiple of 8 and spreads a row with none valid over the padded
    positions too, 1 / Np each; the port, as the reference's jnp twin,
    gives 1 / P.)"""
    ctx, w = m[0].numpy(), m[1].numpy()
    j_ctx, j_w = np.asarray(j[0], np.float32), np.asarray(j[1], np.float32)
    some = np.asarray(lengths) > 0
    return (np.abs(w - j_w)[some].max() <= 1e-4
            and np.abs(ctx - j_ctx)[some].max() <= 1e-3
            and _w_close(w, plain[1].numpy())
            and np.abs(ctx - plain[0].numpy()).max() <= 1e-3)


def _b6_ok_f32(j, m, plain, lengths):
    """fp32: (ctx, w) within F32_ATOL of the JAX kernel on rows with a
    valid position (it spreads a row with none over its padded positions,
    as ``_b6_ok`` says) and of the plain version on every row."""
    ctx, w = m[0].numpy(), m[1].numpy()
    some = np.asarray(lengths) > 0
    return all(
        np.abs(got - np.asarray(want, np.float32))[rows].max() <= F32_ATOL
        for got, want, rows in ((w, j[1], some), (ctx, j[0], some),
                                (w, plain[1].numpy(), slice(None)),
                                (ctx, plain[0].numpy(), slice(None))))


@pytest.mark.parametrize("B,P,A,V,Q,pattern", [
    (8, 36, 512, 2048, 1024, "full"),         # visual class: two groups
    (8, 36, 512, 2048, 1024, "zero_one_full"),
    (6, 22, 64, 96, 96, "zero_one_full"),     # SCMA class, unaligned
    (6, 22, 64, 96, 96, "random"),
    (130, 22, 128, 1024, 64, "zero_one_full"),  # past a 128-row tile
    (3, 5, 128, 2056, 32, "zero_one_full"),     # three column groups
    (4, 7, 128, 1600, 32, "zero_one_full"),     # a group of 576 columns
])
def test_b6_partition_matches_jax_fused(B, P, A, V, Q, pattern):
    """The model of the bf16 B6 kernels gives the JAX kernel's (ctx, w)
    and the plain version's, at prefix lengths 0, 1 and P; a row with none
    valid reads all P values (uniform weights), any other its prefix."""
    case = _b6_case(B, P, A, V, Q, pattern)
    j, m, plain = _b6_both(*case)
    lengths = case[5]
    assert _b6_ok(j, m, plain, lengths)
    assert m[2] == [int(n) if n > 0 else P for n in lengths]
    none_valid = lengths == 0
    if none_valid.any():
        np.testing.assert_allclose(m[1][torch.from_numpy(none_valid)].numpy(),
                                   1.0 / P, rtol=1e-6)
    valid = torch.from_numpy(case[4])
    rows = torch.from_numpy(~none_valid)
    assert bool((m[1][rows][~valid[rows]] == 0).all())


@pytest.mark.parametrize("B,Ap,want", [
    (512, 512, 4),    # the greedy step: 16 tiles, 64 CTAs
    (1024, 512, 4),   # 32 tiles, 128 CTAs
    (1100, 512, 2),   # 36 tiles: 4 ranges would be 144 CTAs
    (2560, 512, 1),   # the bench rows: 80 tiles
    (1024, 1024, 2),  # 64 tiles
    (6, 128, 4),      # one tile
])
def test_query_split_keeps_one_wave(B, Ap, want):
    """The wrapper splits the bf16 query product into as many K ranges (at
    most 4) as keep its CTAs in one wave of an H100's 132 SMs, and sizes
    its scratch qa [split, B, Ap] by it."""
    split = tattn.query_split(B, Ap, H100_SMS)
    assert split == want
    tiles = (Ap // 128) * -(-B // 128)
    assert split * tiles <= H100_SMS or split == 1


@pytest.mark.parametrize("split", [1, 2, 4])
def test_b6_query_split_partials_match_jax(split):
    """The query product in 1, 2 or 4 K ranges, their fp32 partials added
    in rank order, gives the JAX kernel's (ctx, w) within the bars at the
    visual class's widths (Q = 1024) and at an unaligned Q = 96 (ranges of
    24)."""
    for case in (_b6_case(8, 36, 512, 2048, 1024, "zero_one_full"),
                 _b6_case(6, 22, 64, 96, 96, "zero_one_full")):
        j, m, plain = _b6_both(*case, split=split)
        assert _b6_ok(j, m, plain, case[5])


@pytest.mark.parametrize("fault", FAULTS)
def test_b6_partition_planted_faults_fail(fault):
    """A lane's partial score left out of the warp's reduction, or a
    thread's 8 context columns written to the next slice, fails the
    bars at the visual class's shape."""
    case = _b6_case(8, 36, 512, 2048, 1024, "full")
    j, m, plain = _b6_both(*case, fault=fault)
    assert not _b6_ok(j, m, plain, case[5])


@pytest.mark.parametrize("B,P,A,V,Q,split", [
    (8, 36, 512, 2048, 1024, None),  # visual: 4 ranges of 8 stages, 2 groups
    (6, 22, 64, 96, 160, None),      # unaligned: 3 ranges of 1, 2, 2 stages
    (6, 22, 64, 96, 160, 4),         # 4 ranges of 1, 1, 1, 2
    (3, 5, 128, 2056, 32, None),     # one range; three column groups
    (4, 7, 1024, 1600, 64, 2),       # A past the registers: 3 keys a stage;
])                                   # a 576-column group
def test_b6_f32_partition_matches_jax_fused(B, P, A, V, Q, split):
    """The model of B6's fp32 instance (the fp32 tile's K ranges, the
    lanes' 4-column chunks, the accurate tanh, stages of half the
    positions, a thread's two 4-column slices) gives the JAX kernel's
    fp32 (ctx, w) and the plain version's within 1e-5, at prefix lengths
    0, 1 and P; a row with none valid reads all P values, uniformly
    weighted, any other its prefix."""
    case = _b6_case(B, P, A, V, Q, "zero_one_full")
    j, m, plain = _b6_both(*case, split=split, dt=torch.float32)
    lengths = case[5]
    assert _b6_ok_f32(j, m, plain, lengths)
    assert m[2] == [int(n) if n > 0 else P for n in lengths]
    none_valid = torch.from_numpy(lengths == 0)
    torch.testing.assert_close(m[1][none_valid],
                               torch.full_like(m[1][none_valid], 1.0 / P))


@pytest.mark.parametrize("fault", FAULTS)
def test_b6_f32_partition_planted_faults_fail(fault):
    """fp32: a lane's partial score left out, or a thread's two 4-column
    slices written over the next thread's, fails the 1e-5 bar at the
    visual class's shape."""
    case = _b6_case(8, 36, 512, 2048, 1024, "full")
    j, m, plain = _b6_both(*case, fault=fault, dt=torch.float32)
    assert not _b6_ok_f32(j, m, plain, case[5])


def _dcnet_case(B, K, T, H, A, seed=3):
    rng = np.random.default_rng(seed)
    Hp, Ap = _round_up(H, 128), _round_up(A, 128)
    h = np.zeros((B * K, Hp), np.float32)
    h[:, :H] = rng.standard_normal((B * K, H)) * 0.5
    wq = np.zeros((Hp, Ap), np.float32)
    wq[:H, :A] = rng.uniform(-1, 1, (H, A)) * H ** -0.5
    v, b = np.zeros((1, Ap), np.float32), np.zeros((1, Ap), np.float32)
    v[0, :A] = rng.uniform(-1, 1, A) * A ** -0.5
    b[0, :A] = rng.uniform(-0.1, 0.1, A)
    keys = np.zeros((B, T, Ap), np.float32)
    keys[..., :A] = rng.standard_normal((B, T, A)) * 0.5
    lengths = np.array([(0, 1, T)[i % 3] if i < 3 else rng.integers(1, T + 1)
                        for i in range(B)])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return h, wq, v, b, keys, mask


def _dcnet_both(case, K, fault=None, dt=bf):
    h, wq, v, b, keys, mask = case
    jb = jnp.bfloat16 if dt == bf else jnp.float32
    j = jax_megastep._make_dcnet_score_kernel(K, jb)
    from jax.experimental import pallas as pl

    omega = pl.pallas_call(
        j, out_shape=jax.ShapeDtypeStruct((h.shape[0], keys.shape[1]), jb),
        interpret=True)(jnp.asarray(h), jnp.asarray(wq).astype(jb),
                        jnp.asarray(v), jnp.asarray(b),
                        jnp.asarray(keys).astype(jb), jnp.asarray(mask))
    t = [torch.from_numpy(x) for x in case]
    m = _dcnet_model(t[0], t[1].to(dt), t[3][0], t[2][0], t[4].to(dt), t[5],
                     fault)
    return np.asarray(omega, np.float32), m.float().numpy()


def _dcnet_pack(case, dt):
    h, wq, v, b, keys, mask = (torch.from_numpy(x) for x in case)
    small = torch.zeros((128, 128), dtype=dt)
    return h, megastep.DCNetCellPack(
        att_wq=wq.to(dt), att_v=v[0], att_b=b[0], gate_w=small,
        gate_b=small[0].float(), dec_w=small, b=small[0].float(),
        att_keys=keys.to(dt), enc_hs=small[None], mask=mask)


@pytest.mark.parametrize("B,K,T,H,A", [
    (7, 1, 6, 16, 8),        # K = 1, small widths, one 128 block
    (7, 5, 6, 16, 8),        # K = 5 beams a row
    (26, 5, 22, 48, 512),    # A = 512 (two chunks a lane), 130 rows
    (3, 5, 22, 1024, 1024),  # A = 1024 (four chunks), 16 K stages
])
def test_dcnet_score_partition_matches_jax_kernel(B, K, T, H, A):
    """The model of the bf16 dcnet_score kernels gives the reference's
    score kernel's ω (interpret) within one bf16 ulp, and the plain
    version's; masked positions weigh exactly 0, a row with none valid
    weighs all T equally."""
    case = _dcnet_case(B, K, T, H, A)
    j, m = _dcnet_both(case, K)
    assert _ulp_close(m, j)
    h, pack = _dcnet_pack(case, bf)
    assert _ulp_close(m, megastep.reference_dcnet_score(pack, h).float())
    rows = pack.mask.repeat_interleave(K, dim=0)
    valid_rows = rows.sum(dim=1) > 0
    assert bool((torch.from_numpy(m)[valid_rows][rows[valid_rows] == 0]
                 == 0).all())
    np.testing.assert_allclose(m[~valid_rows.numpy()], 1.0 / T, rtol=4e-3)


def test_dcnet_score_partition_planted_fault_fails():
    """A lane's partial score left out of the warp's reduction moves ω
    past one bf16 ulp at A = 512."""
    case = _dcnet_case(26, 5, 22, 48, 512)
    j, m = _dcnet_both(case, 5, fault="lane_share_left_out")
    assert not _ulp_close(m, j)


@pytest.mark.parametrize("B,K,T,H,A", [
    (7, 5, 6, 16, 8),        # one 4-column chunk a lane, 4 K ranges
    (26, 5, 22, 48, 512),    # A = 512: four chunks a lane, 130 rows
    (3, 5, 22, 1024, 1024),  # A = 1024: eight chunks, 4 ranges of 8
])
def test_dcnet_score_f32_partition_matches_jax_kernel(B, K, T, H, A):
    """The model of dcnet_score's fp32 instance (the fp32 tile's K-range
    partials added into q, one warp a row taking its positions two at a
    time from the image's keys in shared memory, the lanes' 4-column
    chunks, the accurate tanh) gives the reference's fp32 score kernel's ω
    (interpret) and the plain version's within 1e-5, at attendable
    lengths 0, 1 and T among others; masked positions weigh exactly 0, a
    row with none attendable weighs all T equally."""
    case = _dcnet_case(B, K, T, H, A)
    j, m = _dcnet_both(case, K, dt=torch.float32)
    assert np.abs(m - j).max() <= F32_ATOL
    h, pack = _dcnet_pack(case, torch.float32)
    plain = megastep.reference_dcnet_score(pack, h).numpy()
    assert np.abs(m - plain).max() <= F32_ATOL
    rows = pack.mask.repeat_interleave(K, dim=0).numpy() > 0
    some = rows.any(axis=1)
    assert (m[some][~rows[some]] == 0).all()
    np.testing.assert_allclose(m[~some], 1.0 / T, rtol=1e-6)


def test_dcnet_score_f32_partition_planted_fault_fails():
    """fp32: a lane's partial score left out of the warp's reduction
    moves ω past 1e-5 at A = 512."""
    case = _dcnet_case(26, 5, 22, 48, 512)
    j, m = _dcnet_both(case, 5, fault="lane_share_left_out",
                       dt=torch.float32)
    assert np.abs(m - j).max() > F32_ATOL


# -- att_cell's score stage ---------------------------------------------------

ATT_FAULTS = ("lane_share_left_out", "visual_given_scma_mask")


def _att_model(h, wq, vis, scma, mask, fault=None):
    """(α [N, R], β [N, T]) as ``att_cell``'s score stage computes them
    from h' [N, Hp] fp32: q = bf16(h') [Wq_vis | Wq_scma] on the wgmma tile
    (fp32: the fp32 tile over the whole K), then ``score_kernel``'s two
    heads, each (b, v, keys): the visual one with no mask, the SCMA one
    masked. ``visual_given_scma_mask``: the visual head reads the SCMA
    mask (its positions past T attendable)."""
    f32 = vis[2].dtype == torch.float32
    q = _query_f32(h, wq, split=1) if f32 else _query(h, wq)
    Ap = vis[2].shape[2]
    R, T = vis[2].shape[1], scma[2].shape[1]
    vis_mask = None
    if fault == "visual_given_scma_mask":
        vis_mask = F.pad(mask, (0, max(0, R - T)), value=1.0)[:, :R]
    lane = fault if fault == "lane_share_left_out" else None
    return (_head_model(q[:, :Ap], *vis, vis_mask, lane),
            _head_model(q[:, Ap:], *scma, mask, lane))


def _att_case(B, K, R, T, E, H, A, seed=5):
    """att_cell's inputs at widths that need no padding (multiples of
    128): a dict of fp32 numpy arrays; caption masks of attendable
    lengths 0, 1 and T, then random."""
    rng = np.random.default_rng(seed)
    N = B * K
    u = lambda *shape, s: rng.uniform(-1, 1, shape).astype(  # noqa: E731
        np.float32) * s
    n = lambda *shape, s: (rng.standard_normal(shape) * s).astype(  # noqa
        np.float32)
    lengths = np.array([(0, 1, T)[i % 3] if i < 3 else rng.integers(1, T + 1)
                        for i in range(B)])
    return dict(
        emb=n(N, E, s=0.1), h_att=n(N, H, s=0.5), c_att=n(N, H, s=0.5),
        h_lang=n(N, H, s=0.5), zvb=n(N, 4 * H, s=0.1),
        w_emb=u(E, 4 * H, s=E ** -0.5), w_hl=u(H, 4 * H, s=H ** -0.5),
        w_ha=u(H, 4 * H, s=H ** -0.5), vis_wq=u(H, A, s=H ** -0.5),
        vis_v=u(A, s=A ** -0.5), vis_b=u(A, s=0.1),
        vis_keys=n(B, R, A, s=0.5), scma_wq=u(H, A, s=H ** -0.5),
        scma_v=u(A, s=A ** -0.5), scma_b=u(A, s=0.1),
        scma_keys=n(B, T, A, s=0.5),
        mask=(np.arange(T)[None, :] < lengths[:, None]).astype(np.float32))


_ATT_JAX = {}


def _att_jax(case, K, dt):
    """The reference's att kernel (``_make_att_kernel``, interpret) on the
    case: (h', c', α, β) as numpy, fp32; one run per case and dtype."""
    key = (id(case), dt)
    if key not in _ATT_JAX:
        from jax.experimental import pallas as pl

        jdt = jnp.bfloat16 if dt == bf else jnp.float32
        N, H = case["h_att"].shape
        B, R, _ = case["vis_keys"].shape
        T = case["scma_keys"].shape[1]
        f32 = jnp.float32
        a = {k: jnp.asarray(x) for k, x in case.items()}
        out = pl.pallas_call(
            jax_megastep._make_att_kernel(K, R, jdt),
            out_shape=[jax.ShapeDtypeStruct((N, H), f32),
                       jax.ShapeDtypeStruct((N, H), f32),
                       jax.ShapeDtypeStruct((N, R), jdt),
                       jax.ShapeDtypeStruct((N, T), jdt)],
            interpret=True)(
            a["emb"].astype(jdt), a["h_att"], a["c_att"], a["h_lang"],
            a["zvb"], *(a[k].astype(jdt) for k in ("w_emb", "w_hl", "w_ha",
                                                    "vis_wq")),
            a["vis_v"][None], a["vis_b"][None], a["vis_keys"].astype(jdt),
            a["scma_wq"].astype(jdt), a["scma_v"][None], a["scma_b"][None],
            a["scma_keys"].astype(jdt), a["mask"])
        _ATT_JAX[key] = [np.array(x, np.float32) for x in out]
    return _ATT_JAX[key]


def _att_pack(case, dt):
    """The port's CellPack of the case's att_cell weights and context."""
    t = {k: torch.from_numpy(x) for k, x in case.items()}
    H = t["h_att"].shape[1]
    small = torch.zeros((128, 128), dtype=dt)
    return megastep.CellPack(
        w_att=torch.cat([t["w_emb"], t["w_hl"], t["w_ha"]]).to(dt),
        wq=torch.cat([t["vis_wq"], t["scma_wq"]], dim=1).to(dt),
        vis_v=t["vis_v"], vis_b=t["vis_b"], scma_v=t["scma_v"],
        scma_b=t["scma_b"], gate_w=small, gate_b=small[0].float(),
        lang_w=small, lang_b=small[0].float(),
        wr=torch.zeros((1, H), dtype=dt), br=small[0].float(),
        vis_keys=t["vis_keys"].to(dt), features=small[None],
        scma_keys=t["scma_keys"].to(dt), enc_cs=small[None],
        scma_mask=t["mask"], zvb=t["zvb"])


def _att_all(case, K, dt, fault=None):
    """(the JAX kernel's (α, β), the model's, the plain version's), each as
    fp32 numpy. The model's query product takes the JAX kernel's h'."""
    j = _att_jax(case, K, dt)
    pack = _att_pack(case, dt)
    m = _att_model(torch.from_numpy(j[0]), pack.wq,
                   (pack.vis_b, pack.vis_v, pack.vis_keys),
                   (pack.scma_b, pack.scma_v, pack.scma_keys),
                   pack.scma_mask, fault)
    plain = megastep.reference_att_cell(
        pack, *(torch.from_numpy(case[k])
                for k in ("emb", "h_att", "c_att", "h_lang")))
    return (j[2], j[3]), tuple(x.float().numpy() for x in m), \
        tuple(x.float().numpy() for x in plain[2:])


def _att_ok(j, m, plain, dt):
    """α and β of the model within one bf16 ulp (fp32: 1e-5) of the JAX
    kernel's and of the plain version's."""
    if dt == bf:
        return all(_ulp_close(m[i], want[i]) for want in (j, plain)
                   for i in (0, 1))
    return all(np.abs(m[i] - want[i]).max() <= F32_ATOL
               for want in (j, plain) for i in (0, 1))


ATT_CASES = {  # B, K, R, T, E, H, A
    "paper_heads": (4, 5, 36, 22, 128, 128, 512),
    "one_beam": (5, 1, 6, 7, 128, 256, 128),
    "wide_a": (3, 3, 10, 9, 128, 128, 1024),
}
_ATT_CASE_DATA = {name: _att_case(*dims) for name, dims in ATT_CASES.items()}


@pytest.mark.parametrize("dt", [bf, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", list(ATT_CASES))
def test_att_cell_score_partition_matches_jax_kernel(name, dt):
    """The model of att_cell's score stage (the query product of both
    heads, then score_kernel: the visual head unmasked, the SCMA head
    masked, a row's scores as its warps take them) gives the reference's
    att kernel's α and β (interpret) and the plain version's within one
    bf16 ulp (fp32: 1e-5): every region weighs, β's masked positions
    weigh exactly 0, a row with no attendable position weighs all T
    equally."""
    B, K, R, T = ATT_CASES[name][:4]
    case = _ATT_CASE_DATA[name]
    j, m, plain = _att_all(case, K, dt)
    assert _att_ok(j, m, plain, dt)
    alpha, beta = m
    assert alpha.shape == (B * K, R) and (alpha > 0).all()
    rows = np.repeat(case["mask"], K, axis=0) > 0
    some = rows.any(axis=1)
    assert some.any() and not some.all()
    assert (beta[some][~rows[some]] == 0).all()
    np.testing.assert_allclose(beta[~some], 1.0 / T,
                               rtol=4e-3 if dt == bf else 1e-6)


@pytest.mark.parametrize("dt", [bf, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("fault", ATT_FAULTS)
def test_att_cell_score_partition_planted_faults_fail(fault, dt):
    """A lane's partial score left out of the warps' sums over A, or the
    visual head given the SCMA head's mask, moves α or β past the bar at
    the paper's heads (36 regions, 22 caption positions, A = 512)."""
    j, m, plain = _att_all(_ATT_CASE_DATA["paper_heads"], 5, dt, fault)
    assert not _att_ok(j, m, plain, dt)
