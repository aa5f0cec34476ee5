"""Kimi-VL's architecture module (``archs/kimi_vl.py``) at a tiny size on
the CPU: its float32 reference (the latent kept as state and decompressed
each step) against the repository's cache-free reference
(``tests/kimi_vl_reference.py``), the port against it through the beam,
a tiny run of the cell, the configuration against the catalog's numbers,
and the new readers and marks."""

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from ckbench import archs, kimi_marks, run, spec
from ckbench.record import Record
from ckbench.reference.check import beam_search as ref_beam
from ckbench.reference.model import Weights
from ckbench.roofline_moe import experts_bound_s

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "tests"))
import kimi_vl_reference as repo_ref  # noqa: E402

TINY = {"model.vocab_size": 300, "model.hidden_dim": 64,
        "model.feat_dim": 48, "model.num_regions": 5, "model.num_layers": 3,
        "model.num_heads": 4, "model.kv_lora_rank": 32,
        "model.qk_nope_head_dim": 16, "model.qk_rope_head_dim": 8,
        "model.v_head_dim": 16, "model.intermediate_size": 96,
        "model.moe_intermediate_size": 32, "model.n_routed_experts": 8,
        "model.num_experts_per_tok": 3, "model.n_shared_experts": 2,
        "model.projector_dim": 80}
CONF = json.loads((ROOT / "ckbench/configs/kimi_vl_a3b_beam5.json")
                  .read_text())
START = 298


def _tiny(**over):
    m = dict(CONF["model"], **{k[6:]: v for k, v in TINY.items()}, **over)
    arch = archs.get("kimi_vl")
    w = arch.make_weights(m, 2147483001, "cpu")
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(4, m["num_regions"], m["feat_dim"], generator=g)
    existing = torch.randint(4, m["vocab_size"] - 2, (4, 7), generator=g)
    lengths = torch.tensor([7, 2, 5, 3])
    return m, arch, w, feats, existing, lengths


def test_the_cached_reference_equals_the_full_forward():
    """Teacher-forced through the module's reference (latent state,
    decompressed each step, padded prompts masked), each step's logits
    equal the cache-free forward of the image's own sequence: float32
    sums in another order."""
    m, arch, w, feats, existing, lengths = _tiny()
    encode, state0, step = arch.reference
    rw = Weights(w)
    ctx = encode(rw, feats, existing, lengths)
    state = state0(rw, ctx)
    g = torch.Generator().manual_seed(9)
    tok = torch.full((4,), START)
    hist = [[] for _ in range(4)]
    for _ in range(4):
        state, logits = step(rw, ctx, state, tok)
        for b in range(4):
            want = repo_ref.forward(w, m, feats[b], existing[b, :lengths[b]],
                                    torch.tensor([START] + hist[b]))[-1]
            torch.testing.assert_close(logits[b], want, atol=2e-4, rtol=0)
        tok = torch.randint(4, m["vocab_size"] - 2, (4,), generator=g)
        hist = [h + [int(t)] for h, t in zip(hist, tok)]


def test_the_port_beam_equals_the_reference_beam_in_float32():
    """The port (through the module's ``program``, float32 products)
    and the reference's beam search give the same captions and scores."""
    from captionkit_torch.decode.beam import beam_search

    m, arch, w, feats, existing, lengths = _tiny(compute_dtype="float32")
    _, model, params = arch.program(m, w, "cpu")
    ctx = model.encode(params, feats, existing, lengths)
    res = beam_search(model, params, ctx, beam_size=3, start_id=START,
                      end_id=-1, max_len=5)
    best, seq = ref_beam(w, arch.reference, feats, existing, lengths, START,
                         3, 5)
    assert torch.equal(res.tokens.long(), seq)
    torch.testing.assert_close(res.scores, best, atol=1e-4, rtol=0)


def test_a_tiny_run_of_the_cell_is_correct_and_its_fp8_control_is_not():
    args = ["--workload", "kimi_vl_offline_b1024", "--seed", "2147483011",
            "--seconds", "0.2", "--trace", "0", "--traffic-set", "images=12",
            "--traffic-set", "batch_size=4", "--traffic-set", "sample=6"]
    sets = dict(TINY, **{"model.compute_dtype": "float32",
                         "limits.topk_gap": 1e-4, "limits.score_err": 1e-4,
                         "limits.head_err": 1e-4})
    result = run.main(args, device="cpu", config_set=sets)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 12 and result["failed"] == 0
    assert set(result["metrics"]) == {"captions_per_s", "setup_s"}
    control = run.main(args + ["--control", "fp8"], device="cpu",
                       config_set=sets)
    assert not control["correct"]


#: Kimi-VL-A3B-Instruct's config.json (text_config), the configuration's
#: source
PUBLISHED = {
    "vocab_size": 163840, "hidden_size": 2048, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "n_shared_experts": 2, "n_routed_experts": 64,
    "routed_scaling_factor": 2.446, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "qk_nope_head_dim": 128, "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "num_experts_per_tok": 6, "first_k_dense_replace": 1,
    "norm_topk_prob": True, "scoring_func": "sigmoid", "rms_norm_eps": 1e-5,
    "rope_theta": 800000, "rope_scaling": None, "attention_bias": False,
    "tie_word_embeddings": False, "hidden_act": "silu",
    "max_position_embeddings": 131072}


def test_the_configuration_holds_the_published_numbers_at_their_widths():
    for key, value in PUBLISHED.items():
        assert CONF[key] == value, key
    m = CONF["model"]
    pairs = {"vocab_size": "vocab_size", "hidden_dim": "hidden_size",
             "num_layers": "num_hidden_layers",
             "num_heads": "num_attention_heads",
             "intermediate_size": "intermediate_size",
             "moe_intermediate_size": "moe_intermediate_size",
             "n_routed_experts": "n_routed_experts",
             "num_experts_per_tok": "num_experts_per_tok",
             "n_shared_experts": "n_shared_experts",
             "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim",
             "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim",
             "first_k_dense_replace": "first_k_dense_replace",
             "routed_scaling_factor": "routed_scaling_factor",
             "norm_topk_prob": "norm_topk_prob",
             "rms_norm_eps": "rms_norm_eps", "rope_theta": "rope_theta"}
    for ours, theirs in pairs.items():
        assert m[ours] == CONF[theirs], ours
    assert CONF["reduced"] == []
    from captionkit_torch.config import ModelConfig
    from captionkit_torch.models.kimi_vl import weight_table

    assert sum(math.prod(shape) for _, shape, _, _ in weight_table(
        ModelConfig(**m))) == 15978995328


def test_the_flops_of_a_caption_at_the_published_widths():
    """~5.2 GFLOP a decode row-step (the routed and shared experts ~70%
    of it), the prefill and projector once an image."""
    m = CONF["model"]
    arch = archs.get("kimi_vl")
    total = arch.caption_flops(m, beam=5, steps=22, t=22)
    one = arch.caption_flops(m, beam=5, steps=1, t=22)
    assert 0.7e12 < total < 0.9e12
    row_step = (total - one) / (21 * 5)
    assert 5.0e9 < row_step < 5.6e9
    experts = 26 * (6 + 2) * 6 * 2048 * 1408
    assert 0.65 < experts / row_step < 0.75


def test_the_expert_roofline_at_the_cell_shape():
    """5,120 rows x 6 slots over 64 experts: 531 GFLOP (0.537 ms at 989
    TFLOP/s) against 1.36 GB (0.405 ms at 3.35 TB/s): bound by the
    products; with four experts hit the bytes fall, the products stay."""
    S, H, I = 30720, 2048, 1408
    assert experts_bound_s(S, 64, H, I) == pytest.approx(
        6 * S * H * I / 989e12)
    assert experts_bound_s(48, 64, H, I) == pytest.approx(
        2 * (3 * H * I * 64 + 2 * 48 * H) / 3.35e12)


def _record(counters, spans=None, named=()):
    trace = SimpleNamespace(window_s=1.0, named=lambda p: [
        s for s in named if s.name.startswith(p)])
    r = Record(workload="kimi_vl_offline_b1024", arch="kimi_vl",
               model=CONF["model"], decode=CONF["decode"], traffic={},
               trace=trace, trace_batches=2)
    return r, {"spans": spans or {}, "counters": counters}


def test_the_load_ratio_and_the_roofline_read_the_ports_counters(
        monkeypatch):
    from ckbench import program_spans
    from ckbench.trace import Span

    call = Span("ckbench.call.grouped_experts|30720|0|0", 0.0, 1.0,
                device=[(0.0, 1000.0, "kernel", "a")])  # 1 ms
    r, s = _record({"moe.slots": 61440, "moe.busiest": 2 * 64 * 1200,
                    "moe.experts_hit": 128},
                   {"moe.experts": {"count": 2}}, [call, call])
    monkeypatch.setattr(program_spans, "summary", lambda r: s)
    assert spec.reader("moe.load_max_ratio")(r) == pytest.approx(2.5)
    roof = spec.reader("moe.experts_roofline")(r)
    assert roof == pytest.approx(100 * 6 * 30720 * 2048 * 1408 / 989e12
                                 / 1e-3)
    monkeypatch.setattr(program_spans, "summary", lambda r: None)
    assert spec.reader("moe.load_max_ratio")(r) is None
    assert spec.reader("moe.experts_roofline")(r) is None


def test_the_marks_name_the_new_wrappers_only_inside_a_profiler_session():
    from captionkit_torch.nn import moe

    kimi_marks.install()
    kimi_marks.install()  # once a process
    assert moe.moe_layer._ckbench_mark
    assert not getattr(moe.moe_layer.__wrapped__, "_ckbench_mark", False)
    m, arch, w, feats, existing, lengths = _tiny(compute_dtype="float32")
    _, model, params = arch.program(m, w, "cpu")
    model.encode(params, feats, existing, lengths)  # outside: no names
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ctx = model.encode(params, feats, existing, lengths)
        ctx = model.beam_expand(ctx, 2)
        state = model.init_state(params, ctx, max_len=1)
        model.step(params, ctx, state, torch.full((8,), START))
    names = {e.key.split("|")[0]: e.key for e in prof.key_averages()
             if e.key.startswith("ckbench.call.")}
    assert set(names) == {f"ckbench.call.{n}" for n in (
        "mla_prefill", "mla_decode", "moe_layer", "grouped_experts")}
    assert names["ckbench.call.moe_layer"].startswith(
        "ckbench.call.moe_layer|8|")
