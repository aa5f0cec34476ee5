#!/usr/bin/env python3
"""Bring-up check of ``captionkit_torch`` on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

1. device   — CUDA present; the card's name and power limit (nvidia-smi).
2. build    — every kernel of ``captionkit_torch/csrc`` built by nvcc.
3. head     — the fused vocab-head kernel against its plain version on the
              card: paper shape (N = 512 images x 5 beams, H = 1024,
              V = 9490) in bf16, and exact-tie patterns across the kernel's
              128-wide vocab tiles; kernel, plain and library times.
4. serve    — the main path: EditNet at paper width (editnet_beam5,
              random weights from seed 0 through the .npz bridge) behind
              ``CaptionServer(batch=512)``, answering JSON-lines requests
              through ``serve_stream``; the head kernel's launches counted.
5. decode   — one forced-full 22-step beam=5 decode of a 512-image batch
              (end id -1, as the reference's bench.py does), 22 head
              launches per batch, captions/s (median of 3 runs), and the
              same batch decoded with the plain head for agreement.

Then a {"kernels": [...]} line, the nvidia-smi line, and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Kernels are built into build/captionkit_torch/ under the checkout; the
scratch files of the run go to build/captionkit_torch/smoke/.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "captionkit_torch" / "smoke"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

N_IMAGES, BEAM, MAX_LEN = 512, 5, 22
HEAD_ATOL = 1e-3  # fp32 sums of 1024 bf16 products in another order


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of one call, from CUDA events over ``iters``
    back-to-back calls after ``warm`` untimed ones."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from captionkit_torch.nn.cells import matmul_route

    smi = nvidia_smi_line()
    info = {"phase": "device", "ok": True,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_route": matmul_route("cuda")}
    emit(info)
    return info


def phase_build():
    from captionkit_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build(verbose=True)
    emit({"phase": "build", "ok": True, "sources": list(build.SOURCES),
          "seconds": time.perf_counter() - t0, "per_source": seconds})


def _head_inputs(N, H, V, seed):
    import torch

    from captionkit_torch.kernels.head import prepad_head

    g = torch.Generator().manual_seed(seed)
    h = torch.randn((N, H), generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn((H, V), generator=g) * 0.03).cuda()
    b = (torch.randn((V,), generator=g) * 0.01).cuda()
    w_p, b_p = prepad_head(w, b, compute_dtype=torch.bfloat16)
    return h, w_p, b_p


def head_agreement(got, want) -> dict:
    """idx agreement and max |err| of vals and lse between two heads'
    (vals, idx, lse), and whether they are within the bar: idx agreement
    >= 0.999, vals and lse within HEAD_ATOL, lse finite."""
    import torch

    (v1, i1, l1), (v2, i2, l2) = got, want
    out = {"idx_agreement": float((i1 == i2).float().mean()),
           "vals_max_abs_err": float((v1 - v2).abs().max()),
           "lse_max_abs_err": float((l1 - l2).abs().max())}
    out["ok"] = (out["idx_agreement"] >= 0.999
                 and out["vals_max_abs_err"] <= HEAD_ATOL
                 and out["lse_max_abs_err"] <= HEAD_ATOL
                 and bool(torch.isfinite(l1).all()))
    return out


def planted_faults(head):
    """(name, faulted copy of ``head``) for faults that a head with a
    wrong log-sum-exp or a wrong per-row rank would show; the bar of
    ``head_agreement`` must reject each."""
    v, i, l = head
    shifted = l.clone()
    shifted[::97] += 2 * HEAD_ATOL  # every 97th row's lse a little off
    swapped_v, swapped_i = v.clone(), i.clone()
    swapped_v[:, [0, 1]] = v[:, [1, 0]]  # ranks 0 and 1 exchanged
    swapped_i[:, [0, 1]] = i[:, [1, 0]]
    return [("lse_shift", (v, i, shifted)),
            ("rank_swap", (swapped_v, swapped_i, l))]


def _tie_patterns():
    """(name, h, w, b, k) of the reference's exact-tie tests
    (tests/test_ops_pallas.py): every value is exact in bf16."""
    import numpy as np
    import torch

    cases = []
    cases.append(("all_equal", np.ones((8, 16), np.float32),
                  np.ones((16, 200), np.float32),
                  np.zeros((200,), np.float32), 4))
    N, V = 8, 384
    pat = np.zeros((N, V), np.float32)
    pat[0, [7, 130, 300]] = 4.0
    pat[0, [12, 260]] = 3.0
    pat[1, [300, 5, 129, 383, 0]] = [9, 8, 7, 6, 5]
    pat[2, :] = 1.0
    pat[3, [126, 127, 128, 129, 255]] = 2.0
    pat[4, [200, 10, 210]] = [5.0, 5.0, 5.0]
    pat[5, :] = -1.0
    pat[5, [50, 150, 250]] = 0.0
    rng = np.random.default_rng(0)
    for r in (6, 7):
        pat[r] = rng.integers(-3, 3, V).astype(np.float32)
    cases.append(("adversarial_duplicates", np.eye(N, dtype=np.float32),
                  pat, np.zeros((V,), np.float32), 5))
    return [(name, torch.from_numpy(h).to("cuda", torch.bfloat16),
             torch.from_numpy(w).to("cuda", torch.bfloat16),
             torch.from_numpy(b).cuda(), k)
            for name, h, w, b, k in cases]


def phase_head():
    import torch

    from captionkit_torch.kernels.head import (
        fused_head_topk,
        reference_head_topk,
    )

    N, H, V, k = N_IMAGES * BEAM, 1024, 9490, BEAM
    h, w, b = _head_inputs(N, H, V, seed=7)
    got = fused_head_topk(h, w, b, k=k)
    torch.cuda.synchronize()
    agree = head_agreement(got, reference_head_topk(h, w, b, k))
    check(agree["ok"], f"kernel vs plain head at paper shape: {agree}")

    ties = {}
    for name, th, tw, tb, tk in _tie_patterns():
        a = fused_head_topk(th, tw, tb, k=tk)
        r = reference_head_topk(th, tw, tb, tk)
        exact = bool(torch.equal(a[0], r[0]) and torch.equal(a[1], r[1]))
        lse_gap = float((a[2] - r[2]).abs().max())
        ties[name] = {"exact": exact, "lse_err": lse_gap}
        check(exact, f"tie pattern {name}: kernel {a[1].tolist()} vs "
                     f"plain {r[1].tolist()}")
        check(lse_gap <= 1e-5, f"tie pattern {name}: lse err {lse_gap}")

    def library():
        logits = torch.matmul(h, w).float() + b
        vals, idx = torch.topk(logits, k, dim=1)
        return vals, idx, torch.logsumexp(logits, dim=1)

    kernel_ms = time_ms(lambda: fused_head_topk(h, w, b, k=k))
    plain_ms = time_ms(lambda: reference_head_topk(h, w, b, k))
    library_ms = time_ms(library)
    # The bound counts the function's own vocab V, not the padded width
    # Vp that the kernel sweeps: h and W[:, :V] read once, outputs written
    # once, 2*N*H*V bf16 operations.
    Vp = w.shape[1]
    flops = 2.0 * N * H * V
    n_bytes = N * H * 2 + H * V * 2 + V * 4 + N * k * 8 + N * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    result = {
        "phase": "head", "ok": True, "shape": [N, H, V], "padded_v": Vp,
        "k": k,
        "idx_agreement": agree["idx_agreement"],
        "vals_max_abs_err": agree["vals_max_abs_err"],
        "lse_max_abs_err": agree["lse_max_abs_err"], "atol": HEAD_ATOL,
        "ties": ties,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_us": 1e3 * bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "kernel_tflops": flops / (kernel_ms * 1e-3) / 1e12,
    }
    emit(result)
    return result


def _paper_setup():
    """editnet_beam5 at paper width, a 9490-word wordmap, and random
    weights from seed 0 written and read back through the .npz bridge."""
    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.data import SyntheticCaptionSource, Vocab
    from captionkit_torch.models import get_model
    from captionkit_torch.params import load_params_npz, save_params_npz

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    cfg = get_named_config("editnet_beam5").override(
        {"decode.batch_size": N_IMAGES})
    V = cfg.model.vocab_size
    toy = SyntheticCaptionSource(num_images=2, captions_per_image=1,
                                 with_features=False).vocab
    words = [w for w in toy.word2id if not w.startswith("<")]
    words += [f"word{i:04d}" for i in range(V - 4 - len(words))]
    vocab = Vocab.build([words], min_freq=1)
    check(len(vocab) == V, f"wordmap has {len(vocab)} entries, not {V}")
    wordmap = SMOKE_DIR / "WORDMAP.json"
    vocab.save(str(wordmap))
    vocab = Vocab.load(str(wordmap))
    model = get_model(cfg.model)
    npz = SMOKE_DIR / "params.npz"
    save_params_npz(model.init(0, "cpu"), str(npz))
    params = load_params_npz(str(npz), "cuda")
    torch.cuda.synchronize()
    return cfg, model, params, vocab


def phase_serve(cfg, model, params, vocab, wrappers):
    import numpy as np

    from captionkit_torch.serve import CaptionServer, serve_stream

    R, F = cfg.model.num_regions, cfg.model.feat_dim
    rng = np.random.default_rng(1)
    paths = []
    for i in range(4):
        p = SMOKE_DIR / f"feat{i}.npy"
        np.save(p, rng.standard_normal((R, F)).astype(np.float32))
        paths.append(str(p))
    caps = ["a man riding a horse on the beach",
            "two people holding a red umbrella",
            "a dog sitting on a wooden bench",
            "a cat looking at a laptop"]
    n_req = N_IMAGES + 4  # one full batch, then a flush of 4 on rung 8
    lines = [json.dumps({"id": i, "caption": caps[i % 4],
                         "features": paths[i % 4]}) for i in range(n_req)]
    server = CaptionServer(cfg, params, model, vocab, ladder=(8,),
                           device="cuda")
    server.warmup()
    for w in wrappers:
        w.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    served = serve_stream(server, io.StringIO("\n".join(lines) + "\n"), out)
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    check(replies[0].get("ready") is True, f"no ready line: {replies[:1]}")
    answers = [r for r in replies[1:] if "caption" in r]
    check(served == n_req and len(answers) == n_req,
          f"served {served}, answered {len(answers)} of {n_req}: "
          f"{[r for r in replies if 'error' in r][:3]}")
    check(sorted(r["id"] for r in answers) == list(range(n_req)),
          "response ids do not match the requests")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    result = {"phase": "serve", "ok": True, "requests": n_req,
              "batches": [N_IMAGES, 8], "wall_s": wall,
              "launches": launches,
              "sample": answers[0]["caption"][:120]}
    emit(result)
    return result


def phase_decode(cfg, model, params, vocab, wrappers, card):
    import dataclasses

    import numpy as np
    import torch

    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.kernels.head import fused_head_topk
    from captionkit_torch.models import get_model

    mc = cfg.model
    r = np.random.default_rng(0)
    feats = torch.from_numpy(r.standard_normal(
        (N_IMAGES, mc.num_regions, mc.feat_dim)).astype(np.float32))
    existing = torch.from_numpy(
        r.integers(4, mc.vocab_size - 2, (N_IMAGES, MAX_LEN)))
    existing_len = torch.from_numpy(
        r.integers(8, MAX_LEN + 1, (N_IMAGES,)))
    batch = (feats, existing, existing_len)
    kw = dict(start_id=vocab.start, end_id=-1, pad_id=vocab.pad,
              device="cuda")
    decode = make_decode_fn(model, cfg.decode, **kw)
    decode(params, *batch).cpu()  # warm-up
    for w in wrappers:
        w.launches = 0
    tokens = decode(params, *batch).cpu()
    launches = fused_head_topk.launches
    check(launches == MAX_LEN,
          f"{launches} head launches for one batch, expected {MAX_LEN}")
    check(tuple(tokens.shape) == (N_IMAGES, MAX_LEN),
          f"tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < mc.vocab_size)).all()),
          "token ids out of range")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        decode(params, *batch).cpu()
        runs.append(N_IMAGES / (time.perf_counter() - t0))
    cps = statistics.median(runs)

    plain_model = get_model(dataclasses.replace(mc, head_impl="xla"))
    plain_decode = make_decode_fn(plain_model, cfg.decode, **kw)
    plain = plain_decode(params, *batch).cpu()
    t0 = time.perf_counter()
    plain_decode(params, *batch).cpu()
    plain_cps = N_IMAGES / (time.perf_counter() - t0)
    token_agree = float((tokens == plain).float().mean())
    row_agree = float((tokens == plain).all(dim=1).float().mean())
    first_agree = float((tokens[:, 0] == plain[:, 0]).float().mean())
    # Both heads sum bf16 products in fp32 in different orders, so a
    # near-tie among candidates may flip and change an image's caption
    # from that step on; a wrong head agrees on almost nothing.
    check(token_agree >= 0.5,
          f"tokens agree with the plain head on {token_agree} < 0.5")
    steps = _check_steps(model, params, batch, kw)
    profile = _profile(lambda: decode(params, *batch).cpu())
    # The profiler slows the host; set the device time against the
    # unprofiled median wall of one batch too.
    profile["busy_share_of_timed_wall"] = \
        profile["device_ms"] / (1e3 * N_IMAGES / cps)
    result = {"phase": "decode", "ok": True, "card": card, "batch": N_IMAGES,
              "beam": BEAM, "steps": MAX_LEN, "head_launches": launches,
              "captions_per_s": cps, "runs": runs,
              "spread_pct": 100.0 * (max(runs) - min(runs)) / cps,
              "plain_head_captions_per_s": plain_cps,
              "token_agreement": token_agree, "row_agreement": row_agree,
              "first_token_agreement": first_agree, "steps_check": steps,
              "profile": profile}
    emit(result)
    return result


def _check_steps(model, params, batch, kw) -> dict:
    """The head kernel against the plain head on the states the decode
    visits: the batch's K hypotheses per image (``all_tokens`` of one
    kernel decode) are fed back step by step, and at each of the 22 steps
    the kernel's (vals, idx, lse) from ``step_topk`` are held against
    ``reference_head_topk`` on the same hidden state, within the bar of
    ``head_agreement``. Planted faults (a shifted lse on a few rows,
    ranks 0 and 1 exchanged) must fail that bar, which shows it would
    catch them. Launches made here are not counted as the main path's."""
    import torch

    from captionkit_torch.decode.beam import beam_search
    from captionkit_torch.kernels.head import reference_head_topk

    feats, existing, existing_len = (t.cuda() for t in batch)
    worst = {"idx_agreement": 1.0, "vals_max_abs_err": 0.0,
             "lse_max_abs_err": 0.0}
    faults_caught = {}
    with torch.inference_mode():
        ctx = model.encode(params, feats, existing, existing_len)
        res = beam_search(model, params, ctx, beam_size=BEAM,
                          start_id=kw["start_id"], end_id=kw["end_id"],
                          pad_id=kw["pad_id"], max_len=MAX_LEN)
        hyps = res.all_tokens.reshape(N_IMAGES * BEAM, MAX_LEN)
        ctx_k = model.prepare_topk(params, model.beam_expand(ctx, BEAM),
                                   BEAM)
        state = model.init_state(params, ctx_k)
        tok = torch.full((N_IMAGES * BEAM,), kw["start_id"],
                         dtype=torch.int32, device="cuda")
        w = params.fc_w.to(torch.bfloat16)
        for t in range(MAX_LEN):
            state, *got = model.step_topk(params, ctx_k, state, tok, BEAM)
            want = reference_head_topk(state.h_lang.to(torch.bfloat16), w,
                                       params.fc_b, BEAM)
            agree = head_agreement(got, want)
            check(agree["ok"], f"step {t}: kernel vs plain head on the "
                               f"decode's state: {agree}")
            worst["idx_agreement"] = min(worst["idx_agreement"],
                                         agree["idx_agreement"])
            for key in ("vals_max_abs_err", "lse_max_abs_err"):
                worst[key] = max(worst[key], agree[key])
            if t == 0:
                for name, bad in planted_faults(got):
                    faults_caught[name] = not head_agreement(bad, want)["ok"]
            tok = hyps[:, t].contiguous()
    for name, caught in faults_caught.items():
        check(caught, f"planted fault {name} passes the head bar")
    return {"steps": MAX_LEN, "atol": HEAD_ATOL, **worst,
            "planted_faults_caught": faults_caught}


def _profile(run, top: int = 12) -> dict:
    """One run under torch.profiler: its host wall time, the summed time
    of the activities on the card (kernels, copies; one stream, so their
    sum is the busy time) and the ones that took longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(
        ((ev.self_device_time_total, ev.key, ev.count)
         for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA
         and ev.self_device_time_total > 0
         and "Buffer Request" not in ev.key),  # a tracer event, not work
        reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top": [{"op": k[:80], "ms": us / 1e3, "count": n}
                    for us, k, n in rows[:top]]}


def main() -> int:
    if not (ROOT / "captionkit_torch" / "csrc").is_dir():
        print("chip_smoke.py: no captionkit_torch package beside it",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phase = "device"
    try:
        info = phase_device()
        phase = "build"
        phase_build()
        phase = "head"
        head = phase_head()
        phase = "setup"
        from captionkit_torch.kernels import WRAPPERS

        cfg, model, params, vocab = _paper_setup()
        phase = "serve"
        serve = phase_serve(cfg, model, params, vocab, WRAPPERS)
        phase = "decode"
        decode = phase_decode(cfg, model, params, vocab, WRAPPERS,
                              info["nvidia_smi"])
    except Exception as e:  # every failed phase ends the run non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    emit({"kernels": [{
        "name": "fused_head_topk",
        "route": "cuda",
        "source": "captionkit_torch/csrc/head_topk.cu",
        "replaces": "captionkit/ops/head.py:490",
        "launches": serve["launches"]["fused_head_topk"],
        "launches_per_batch": decode["head_launches"],
        "check": "ok",
        "max_abs_err": max(head["vals_max_abs_err"],
                           head["lse_max_abs_err"],
                           decode["steps_check"]["vals_max_abs_err"],
                           decode["steps_check"]["lse_max_abs_err"]),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
