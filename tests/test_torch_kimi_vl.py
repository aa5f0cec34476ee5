"""Kimi-VL-A3B's language model in the port (``models/kimi_vl.py``,
``nn/mla.py``, ``nn/moe.py``) against the plain float32 reference
(``tests/kimi_vl_reference.py``: the full forward, no cache) at a tiny
size on the CPU, on seeded random weights, in float32 (the tolerances are
float32 sums in another order: the absorbed attention and the cached
latent reassociate the products)."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kimi_vl_reference as ref
from captionkit_torch.config import ModelConfig
from captionkit_torch.decode.beam import _reorder_rows, beam_search
from captionkit_torch.models import get_model
from captionkit_torch.models.kimi_vl import dims, init_tensors
from captionkit_torch.nn import mla, moe
from captionkit_torch.params import kimi_vl_params_from_tensors

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(arch="kimi_vl", vocab_size=300, hidden_dim=64, feat_dim=48,
            num_regions=5, num_layers=3, num_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=2,
            projector_dim=80, compute_dtype="float32")
START = 298
ATOL = 2e-4  # logits of about unit size, float32 sums reordered


def _setup(seed=0, **over):
    cfg = ModelConfig(**{**TINY, **over})
    w = init_tensors(seed, cfg, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    feats = torch.randn(3, cfg.num_regions, cfg.feat_dim, generator=g)
    existing = torch.randint(4, cfg.vocab_size - 2, (3, 6), generator=g)
    lengths = torch.tensor([6, 2, 4])
    return cfg, w, kimi_vl_params_from_tensors(w, cfg), feats, existing, \
        lengths


def _reference_logits(w, cfg, feats, existing, lengths, history, b):
    """The reference's logits after row history ``history`` of image b."""
    return ref.forward(w, dataclasses.asdict(cfg), feats[b],
                       existing[b, :lengths[b]],
                       torch.tensor([START] + history))[-1]


def test_cached_beam_decode_matches_the_full_forward():
    """Prefill, then four cached steps of two beam rows an image with the
    rows reordered between steps (parents drawn at random, as a beam
    does): every row's logits equal the full forward of its own
    [prompt ; tokens]."""
    cfg, w, params, feats, existing, lengths = _setup()
    model = get_model(cfg)
    K = 2
    ctx = model.beam_expand(model.encode(params, feats, existing, lengths), K)
    state = model.init_state(params, ctx, max_len=4)
    hist = [[] for _ in range(3 * K)]
    tok = torch.full((3 * K,), START)
    g = torch.Generator().manual_seed(5)
    for _ in range(4):
        state, logits = model.step(params, ctx, state, tok)
        for r in range(3 * K):
            torch.testing.assert_close(
                logits[r], _reference_logits(w, cfg, feats, existing,
                                             lengths, hist[r], r // K),
                atol=ATOL, rtol=0)
        parent = torch.randint(0, K, (3, K), generator=g)
        rows = (torch.arange(3)[:, None] * K + parent).reshape(-1)
        state = _reorder_rows(state, rows)
        tok = torch.randint(4, cfg.vocab_size - 2, (3 * K,), generator=g)
        hist = [hist[int(p)] + [int(t)] for p, t in zip(rows, tok)]


def test_absorbed_decode_equals_decompressed_attention():
    """``mla_decode`` (the absorbed form over the prefix latent and the
    row's own latent) against ``mla_prefill`` (decompressed, causal) on
    the whole sequence: the new position's output and latent."""
    cfg, w, params, *_ = _setup()
    dd = dims(cfg)
    attn = params.layers[1].attn
    g = torch.Generator().manual_seed(3)
    B, P, K = 2, 7, 3
    x = torch.randn(B, P + 2, cfg.hidden_dim, generator=g)
    valid = torch.ones(B, P + 2, dtype=torch.bool)
    cos, sin = mla.rope_tables(torch.arange(P + 2), dd.rope, cfg.rope_theta)
    full, lat = mla.mla_prefill(attn, dd, x, cos, sin, valid, torch.float32)
    # two steps a row, K rows an image sharing its prefix of P positions
    gen = torch.zeros(B * K, 4, dd.latent + dd.rope)
    xr = x.repeat_interleave(K, 0)
    for s in range(2):
        pos = torch.full((B * K,), s)
        out = mla.mla_decode(attn, dd, xr[:, P + s], cos[P + s].expand(
            B * K, -1), sin[P + s].expand(B * K, -1), lat[:, :P],
            valid[:, :P], gen, pos, torch.float32)
        torch.testing.assert_close(out, full[:, P + s].repeat_interleave(
            K, 0), atol=1e-5, rtol=0)
        torch.testing.assert_close(gen[:, s], lat[:, P + s].repeat_interleave(
            K, 0), atol=1e-6, rtol=0)


def test_grouped_experts_match_a_loop_over_experts():
    """The layer's sort, gather, grouped products and combine (the CPU's
    plain grouped products) against the reference's per-expert loop; and
    the card's route through ``torch._grouped_mm`` (bf16, groups' ends,
    the experts' [out, in] weights transposed) against the plain loop."""
    cfg, w, params, *_ = _setup()
    layer = params.layers[2]
    g = torch.Generator().manual_seed(4)
    x = torch.randn(40, cfg.hidden_dim, generator=g)
    got = moe.moe_layer(x, layer.moe, moe.Routing(3, 2.446, True),
                        torch.float32)
    want = ref.moe(w, "layers/2/", dataclasses.asdict(cfg), x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    E = cfg.n_routed_experts
    counts = torch.tensor([5, 0, 9, 1, 0, 12, 3, 10])  # empty groups too
    ends = counts.cumsum(0).to(torch.int32)
    xs = torch.randn(int(counts.sum()), cfg.hidden_dim,
                     generator=g).bfloat16()
    gu = layer.moe.experts_gate_up.bfloat16()
    dn = layer.moe.experts_down.bfloat16()
    grouped = moe.grouped_products(xs, ends, gu, dn)
    plain = moe.grouped_experts_plain(xs, ends.tolist(), gu, dn)
    assert plain.shape == (int(counts.sum()), cfg.hidden_dim) and E == 8
    torch.testing.assert_close(grouped.float(), plain.float(), atol=2e-2,
                               rtol=1e-2)


def test_routing_bias_chooses_and_weights_are_normalised_and_scaled():
    """The correction bias changes which experts are chosen, not their
    weights; the weights are the chosen sigmoid scores over their sum,
    times 2.446."""
    H, E = 4, 6
    router = torch.eye(E, H)  # logits are x's first four entries, then 0
    x = torch.tensor([[2.0, 1.0, -1.0, 0.5]])
    r = moe.Routing(top_k=2, scale=2.446, normalize=True)
    w0, i0 = moe.route(x, router, torch.zeros(E), r)
    assert sorted(i0[0].tolist()) == [0, 1]
    s = torch.sigmoid(torch.tensor([2.0, 1.0]))
    torch.testing.assert_close(w0[0].sort().values,
                               (s / s.sum() * 2.446).sort().values)
    bias = torch.tensor([0.0, 0.0, 5.0, 0.0, 0.0, 0.0])
    w1, i1 = moe.route(x, router, bias, r)
    assert sorted(i1[0].tolist()) == [0, 2]
    s = torch.sigmoid(torch.tensor([2.0, -1.0]))  # scores without the bias
    torch.testing.assert_close(w1[0].sort().values,
                               (s / s.sum() * 2.446).sort().values)
    assert float(w1.sum()) == pytest.approx(2.446, rel=1e-6)


def _reference_beam(w, cfg, feats, existing, lengths, K, steps):
    """A width-K beam over the reference's full forward (no cache): each
    image's best (tokens, summed log-prob)."""
    out = []
    V = cfg.vocab_size
    for b in range(feats.shape[0]):
        beams = [([], 0.0)]
        for _ in range(steps):
            cand = []
            for hist, score in beams:
                lp = torch.log_softmax(_reference_logits(
                    w, cfg, feats, existing, lengths, hist, b), -1)
                cand += [(score + float(lp[v]), hist + [v]) for v in range(V)]
            cand.sort(key=lambda c: -c[0])
            beams = [(h, s) for s, h in cand[:K]]
        out.append(beams[0])
    return out


def test_beam_search_with_the_latent_cache_matches_a_reference_beam():
    """The port's beam search (the fused head's CPU version, the cache
    reordered by parents each step) against a beam over the reference's
    full forward: the same best caption and score per image."""
    cfg, w, params, feats, existing, lengths = _setup(seed=2)
    model = get_model(cfg)
    ctx = model.encode(params, feats, existing, lengths)
    res = beam_search(model, params, ctx, beam_size=3, start_id=START,
                      end_id=-1, max_len=4)
    for b, (tokens, score) in enumerate(_reference_beam(
            w, cfg, feats, existing, lengths, 3, 4)):
        assert res.tokens[b].tolist() == tokens
        assert float(res.scores[b]) == pytest.approx(score, abs=1e-4)


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_the_latent_cache_is_sized_from_the_decode_length(method):
    """The decode state's generated latent holds the decode's own step
    count: ``make_decode_fn`` runs at 3 and at 25 steps (beyond the
    serving default of 22) with a cache of that many positions, and the
    shorter decode is the longer one's first steps; ``init_state``
    without a length raises."""
    from captionkit_torch.config import DecodeConfig
    from captionkit_torch.decode.driver import make_decode_fn
    from captionkit_torch.models import kimi_vl

    cfg, w, params, feats, existing, lengths = _setup(seed=3)
    model = get_model(cfg)
    with pytest.raises(ValueError, match="max_len"):
        model.init_state(params, model.encode(params, feats, existing,
                                              lengths))
    sizes, seen = {}, kimi_vl.init_state

    def spy(params, ctx, max_len=None):
        state = seen(params, ctx, max_len=max_len)
        sizes[max_len] = state.cache.shape[2]
        return state

    model = dataclasses.replace(model, init_state=spy)
    out = {}
    for n in (3, 25):
        dec = DecodeConfig(method=method, beam_size=2, max_decode_len=n)
        fn = make_decode_fn(model, dec, start_id=START, end_id=-1,
                            device="cpu")
        out[n] = fn(params, feats, existing, lengths)
        assert out[n].shape == (3, n)
    assert sizes == {3: 3, 25: 25}
    if method == "greedy":  # a beam's best of 3 steps may leave the 25's
        assert torch.equal(out[25][:, :3], out[3])


def test_the_benchmark_modules_import_no_jax_and_no_reference_package():
    """Importing ``ckbench.archs`` and every architecture module loads no
    jax, jaxlib, flax or captionkit (the JAX package)."""
    code = """
import importlib, json, sys
sys.path.insert(0, %r)
from ckbench import archs
names = sorted(p.stem for p in archs.HERE.glob("*.py") if p.stem != "__init__")
for n in names:
    archs.get(n)
print(json.dumps({"archs": names, "loaded": sorted(
    {m.split(".")[0] for m in sys.modules}
    & {"jax", "jaxlib", "flax", "captionkit"})}))
""" % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"editnet", "dcnet", "kimi_vl"} <= set(got["archs"])
    assert got["loaded"] == []


def test_a_traced_split_records_the_models_spans_and_counters():
    """A Kimi-VL beam over a split inside a profiler session: the prefill,
    attention, expert and reorder spans, and the expert counters read at
    each batch's read-back: every token-slot of every expert layer (the
    prefill's last layer runs no MLP), the busiest expert's share."""
    from captionkit_torch.config import DecodeConfig
    from captionkit_torch.data import SyntheticCaptionSource
    from captionkit_torch.decode.driver import decode_split
    from captionkit_torch.utils import profiling

    src = SyntheticCaptionSource(num_images=5, captions_per_image=1,
                                 num_regions=5, feat_dim=48, max_len=6,
                                 seed=0)
    ds = src.eval_view()
    cfg = ModelConfig(**{**TINY, "vocab_size": len(ds.vocab)})
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    dec = DecodeConfig(beam_size=2, max_decode_len=3, batch_size=4)
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            hyps, _ = decode_split(model, params, ds, dec, device="cpu")
        s = profiling.summary()
    finally:
        profiling.reset()
    assert len(hyps) == 5
    spans = {n: v["count"] for n, v in s["spans"].items()}
    moe_layers = cfg.num_layers - cfg.first_k_dense_replace
    calls = 2 * ((moe_layers - 1) + 3 * moe_layers)  # 2 batches
    assert spans["kimi.prefill"] == 2
    assert spans["mla.attend"] == 2 * 4 * cfg.num_layers
    assert spans["moe.route"] == spans["moe.experts"] == calls
    assert spans["beam.reorder"] == 2 * 3
    P = cfg.num_regions + ds.existing.shape[1]
    tokens_a_batch = (moe_layers - 1) * 4 * P + 3 * moe_layers * 4 * 2
    c = s["counters"]
    assert c["moe.slots"] == 2 * tokens_a_batch * cfg.num_experts_per_tok
    assert c["moe.slots"] <= c["moe.busiest"] <= \
        c["moe.slots"] * cfg.n_routed_experts
    assert c["moe.experts_hit"] <= calls * cfg.n_routed_experts
    # a batch: 4 images' prefix latent and 8 rows' latent of 3 positions,
    # float32
    assert c["kv.cache_bytes"] == 2 * 4 * cfg.num_layers * (
        cfg.kv_lora_rank + cfg.qk_rope_head_dim) * (4 * P + 8 * 3)
