"""The plain float32 reference of ``ckbench/reference`` against the port on
the CPU at a tiny width, from the same seeded flat weights: the logits of
a teacher-forced caption and the beam search's best scores and tokens.
A gate's bias dropped from the port's copy of the weights must fail."""

import pytest
import torch

from captionkit_torch.decode.beam import beam_search as port_beam

from ckbench import archs
from ckbench.reference.check import beam_search as ref_beam
from ckbench.reference.model import Weights

TINY = dict(vocab_size=60, emb_dim=16, hidden_dim=24, att_dim=8,
            feat_dim=32, num_regions=5)
B, T, L, K = 6, 9, 7, 3
TOL = 2e-5  # float32 sums of at most 80 products in another order
BIAS = {"editnet": "att_lstm/b", "dcnet": "decoder/b"}


def _setup(arch, cell_impl, seed=11):
    m = dict(TINY, arch=arch, compute_dtype="float32", cell_impl=cell_impl)
    w = archs.get(arch).make_weights(m, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(B, m["num_regions"], m["feat_dim"], generator=g)
    existing = torch.randint(4, m["vocab_size"] - 2, (B, T), generator=g)
    lengths = torch.tensor([T, 3, 5, 1, 8, 6])
    return m, w, feats, existing, lengths


def _port(arch, m, w):
    """The port's model and params through the architecture's module, on
    a copy of the weights."""
    _, model, params = archs.get(arch).program(
        m, {n: t.clone() for n, t in w.items()}, "cpu")
    return model, params


def _logits_gap(arch, cell_impl, drop=None):
    m, w, feats, existing, lengths = _setup(arch, cell_impl)
    model, params = _port(arch, m, w)
    if drop:
        getattr_path = drop.split("/")
        obj = params
        for part in getattr_path[:-1]:
            obj = getattr(obj, part)
        getattr(obj, getattr_path[-1]).zero_()
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, TINY["vocab_size"], (B, L), generator=g)
    ctx = model.encode(params, feats, existing, lengths)
    state = model.init_state(params, ctx)
    encode, state0, step = archs.get(arch).reference
    rw = Weights(w)
    rctx = encode(rw, feats, existing, lengths)
    rstate = state0(rw, rctx)
    worst = 0.0
    for t in range(L):
        state, logits = model.step(params, ctx, state, tokens[:, t])
        rstate, rlogits = step(rw, rctx, rstate, tokens[:, t])
        worst = max(worst, float((logits - rlogits).abs().max()))
    return worst


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_teacher_forced_logits_match_the_port(arch):
    assert _logits_gap(arch, "xla") < TOL


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_a_dropped_gate_bias_fails(arch):
    assert _logits_gap(arch, "xla", drop=BIAS[arch]) > 100 * TOL


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
@pytest.mark.parametrize("cell_impl", ["xla", "pallas"])
def test_beam_scores_and_tokens_match_the_port(arch, cell_impl):
    """The port's batched beam search (its fused-cell path runs the cell
    kernels' plain versions on the CPU) against the reference's."""
    m, w, feats, existing, lengths = _setup(arch, cell_impl)
    model, params = _port(arch, m, w)
    ctx = model.encode(params, feats, existing, lengths)
    start = TINY["vocab_size"] - 2
    got = port_beam(model, params, ctx, beam_size=K, start_id=start,
                    end_id=-1, max_len=L)
    best, seq = ref_beam(w, archs.get(arch).reference, feats, existing,
                         lengths, start, K, L)
    assert torch.allclose(got.scores, best, atol=1e-4, rtol=0)
    assert torch.equal(got.tokens.long(), seq)
