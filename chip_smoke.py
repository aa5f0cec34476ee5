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
   head_variants — the rest of the head family at paper shape and on the
              tie patterns: the thresh extraction bit-equal to the mask
              kernel, the single sweep within the head's bar (ties exact),
              the int8 head's values and ids bit-equal to its plain
              version (lse within 2e-4); planted faults must fail every
              bar; kernel, plain, library and bound times.
4. serve    — the main path: EditNet at paper width (editnet_beam5,
              random weights from seed 0 through the .npz bridge) behind
              ``CaptionServer(batch=512)``, answering JSON-lines requests
              through ``serve_stream``; the head kernel's launches counted.
5. decode   — one forced-full 22-step beam=5 decode of a 512-image batch
              (end id -1, as the reference's bench.py does), 22 head
              launches per batch, captions/s (median of 3 runs), and the
              same batch decoded with the plain head for agreement.
6. megastep — the four fused decode-cell kernels (EditNet's att_cell and
              lang_cell, DCNet's dcnet_score and dcnet_cell) against their
              plain versions on the card at paper shape, on packs built
              from encoded batches; planted faults must fail the bars;
              kernel, plain and bound times, CUDA launches per call.
7. decode_cells — editnet_beam5 with cell_impl="pallas": a forced-full
              decode of the 512-image batch, 22 launches per batch of
              each cell kernel and of the head, captions/s (median of 3)
              beside the cell_impl="xla" decode's in the same call, token
              agreement, the fused step against the plain step on the
              decode's own states, and a profile.
8. dcnet    — dcnet_beam5 with cell_impl="pallas" (random weights from
              seed 0 through the DCNet .npz bridge) behind
              CaptionServer(batch=512), a forced-full decode (median of
              3, beside cell_impl="xla") and the same steps check.
9. int8     — editnet_beam5 with model.head_quant=int8 and
              decode.feed_dtype=int8 behind CaptionServer(batch=512); a
              forced-full decode (median of 3) beside the default float
              path, token agreement, the int8 head against its plain
              version on the decode's own states (22 steps), the H2D
              copy's device time beside the fp32 feed's; decodes with
              head_extract=thresh (tokens identical to mask, float and
              int8 heads) and with the single sweep (steps check); and
              dcnet_beam5 served once with the int8 head.

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
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_INT8_OPS = 1979e12

N_IMAGES, BEAM, MAX_LEN = 512, 5, 22
HEAD_ATOL = 1e-3  # fp32 sums of 1024 bf16 products in another order
# The int8 head against its plain version: values and ids bit-equal (the
# same arithmetic, exact int8 sums); the log-sum-exp sums the same terms
# in another order (the reference's bar, tests/test_head_quant.py).
INT8_LSE_ATOL = 2e-4
# Cell kernels against their plain versions: h and c are fp32 sums of up
# to 5120 bf16 products in another order, behind one bf16 rounding of an
# operand (v_hat, part) that may fall the other way.
CELL_ATOL = 1e-3
# The whole fused step against the plain step on the same state: besides
# the above, the attention weights are rounded to bf16 before the grouped
# products and may round the other way in one or two positions.
STEP_ATOL = 2e-3


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


def int8_agreement(got, want) -> dict:
    """The int8 head's bar: values and ids bit-equal, lse within
    INT8_LSE_ATOL and finite (the keys of ``head_agreement``)."""
    import torch

    (v1, i1, l1), (v2, i2, l2) = got, want
    out = {"idx_agreement": float((i1 == i2).float().mean()),
           "vals_max_abs_err": float((v1 - v2).abs().max()),
           "lse_max_abs_err": float((l1 - l2).abs().max())}
    out["ok"] = (bool(torch.equal(i1, i2) and torch.equal(v1, v2))
                 and out["lse_max_abs_err"] <= INT8_LSE_ATOL
                 and bool(torch.isfinite(l1).all()))
    return out


def bit_agreement(got, want) -> dict:
    """The thresh extraction's bar against the mask kernel: all three
    outputs bit-equal."""
    import torch

    out = int8_agreement(got, want)
    out["ok"] = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
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


def _int8_inputs(N, H, V, seed):
    """fp32 h on the card (the decode feeds the int8 head fp32 states) and
    the head quantized by ``quantize_head``."""
    import torch

    from captionkit_torch.kernels.head import quantize_head

    g = torch.Generator().manual_seed(seed)
    h = torch.randn((N, H), generator=g).cuda()
    w = (torch.randn((H, V), generator=g) * 0.03).cuda()
    b = (torch.randn((V,), generator=g) * 0.01).cuda()
    return (h, *quantize_head(w, b))


def _int8_tie_patterns():
    """(name, h fp32, w_q, w_scale, b, k): the reference's int8 tie test
    (every column identical, tests/test_head_quant.py) and the float tie
    patterns quantized (h = eye, so row i quantizes to 127 e_i)."""
    import numpy as np
    import torch

    from captionkit_torch.kernels.head import quantize_head

    rng = np.random.default_rng(1)
    col = rng.standard_normal((16, 1)).astype(np.float32)
    cases = [("identical_columns",
              torch.from_numpy(rng.standard_normal((8, 16))
                               .astype(np.float32)).cuda(),
              torch.from_numpy(np.repeat(col, 130, axis=1)).cuda(),
              torch.zeros((130,), device="cuda"), 3)]
    for name, h, w, b, k in _tie_patterns():
        cases.append((name, h.float(), w.float(), b, k))
    return [(name, h, *quantize_head(w, b), k) for name, h, w, b, k in cases]


def _head_bound(N, H, V, k, *, int8: bool) -> dict:
    """Least time of the head at the function's own vocab V: 2 N H V
    products (bf16 or int8 peak) against h, W, scales, bias read once and
    the outputs written once."""
    ops = 2.0 * N * H * V
    if int8:
        n_bytes = N * H * 4 + H * V + 2 * V * 4 + N * k * 8 + N * 4
        t_ops = ops / PEAK_INT8_OPS
    else:
        n_bytes = N * H * 2 + H * V * 2 + V * 4 + N * k * 8 + N * 4
        t_ops = ops / PEAK_BF16_FLOPS
    t_bytes = n_bytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_head_variants():
    """Rows 2, 3 and 4 of the kernel table against their plain versions at
    paper shape and on the tie patterns: the thresh extraction bit-equal to
    the mask kernel, the sweep within the head bar (ties exact), the int8
    head's values and ids bit-equal to its plain version (lse within
    INT8_LSE_ATOL). Each planted fault must fail each bar."""
    import torch

    from captionkit_torch.kernels import head as thead

    N, H, V, k = N_IMAGES * BEAM, 1024, 9490, BEAM
    h, w, b = _head_inputs(N, H, V, seed=7)
    h8, w_q, scale, b8 = _int8_inputs(N, H, V, seed=7)
    mask = thead.fused_head_topk(h, w, b, k=k)
    plain = thead.reference_head_topk(h, w, b, k)
    plain8 = thead.reference_head_topk_int8(h8, w_q, scale, b8, k)
    torch.cuda.synchronize()
    results = {}

    def hold(name, got, want, agree):
        res = agree(got, want)
        check(res["ok"], f"{name} at paper shape: {res}")
        caught = {f: not agree(bad, want)["ok"]
                  for f, bad in planted_faults(got)}
        for f, ok in caught.items():
            check(ok, f"{name}: planted fault {f} passes the bar")
        results[name] = {**res, "bar": agree.__name__,
                         "planted_faults_caught": caught, "ties": {}}

    hold("fused_head_topk_thresh",
         thead.fused_head_topk_thresh(h, w, b, k=k), mask, bit_agreement)
    hold("head_sweep_topk", thead.head_sweep_topk(h, w, b, k=k), plain,
         head_agreement)
    int8 = {e: thead.fused_head_topk_int8(h8, w_q, scale, b8, k=k,
                                          extract=e)
            for e in ("mask", "thresh")}
    hold("fused_head_topk_int8", int8["mask"], plain8, int8_agreement)
    check(bit_agreement(int8["thresh"], int8["mask"])["ok"],
          "int8 head: thresh extraction differs from mask")

    for name, th, tw, tb, tk in _tie_patterns():
        mask_t = thead.fused_head_topk(th, tw, tb, k=tk)
        plain_t = thead.reference_head_topk(th, tw, tb, tk)
        for kname, got in (
                ("fused_head_topk_thresh",
                 thead.fused_head_topk_thresh(th, tw, tb, k=tk)),
                ("head_sweep_topk", thead.head_sweep_topk(th, tw, tb, k=tk))):
            exact = bool(torch.equal(got[0], plain_t[0])
                         and torch.equal(got[1], plain_t[1]))
            lse_err = float((got[2] - plain_t[2]).abs().max())
            if kname == "fused_head_topk_thresh":
                exact = exact and bit_agreement(got, mask_t)["ok"]
            results[kname]["ties"][name] = {"exact": exact,
                                            "lse_err": lse_err}
            check(exact and lse_err <= 1e-5,
                  f"{kname} tie pattern {name}: {got[1].tolist()} vs "
                  f"{plain_t[1].tolist()}, lse err {lse_err}")
    for name, th, tq, ts, tb, tk in _int8_tie_patterns():
        want = thead.reference_head_topk_int8(th, tq, ts, tb, tk)
        for e in ("mask", "thresh"):
            got = thead.fused_head_topk_int8(th, tq, ts, tb, k=tk, extract=e)
            res = int8_agreement(got, want)
            results["fused_head_topk_int8"]["ties"][f"{name}/{e}"] = {
                "exact": res["ok"], "lse_err": res["lse_max_abs_err"]}
            check(res["ok"], f"int8 tie pattern {name} ({e}): "
                             f"{got[1].tolist()} vs {want[1].tolist()}")

    def library():
        logits = torch.matmul(h, w).float() + b
        vals, idx = torch.topk(logits, k, dim=1)
        return vals, idx, torch.logsumexp(logits, dim=1)

    def library8():
        h_q, s_h = thead.quantize_rows(h8)
        acc = torch._int_mm(h_q, w_q)
        logits = acc.float() * (s_h * scale[None, :]) + b8
        vals, idx = torch.topk(logits, k, dim=1)
        return vals, idx, torch.logsumexp(logits, dim=1)

    try:
        library8()
        library8_ms, library8_error = time_ms(library8), None
    except RuntimeError as e:  # a torch without the int8 product
        library8_ms, library8_error = None, str(e)[:200]
    library_ms = time_ms(library)
    plain_ms = time_ms(lambda: thead.reference_head_topk(h, w, b, k))
    timings = {
        "fused_head_topk_thresh": (
            lambda: thead.fused_head_topk_thresh(h, w, b, k=k), plain_ms,
            library_ms, False),
        "head_sweep_topk": (
            lambda: thead.head_sweep_topk(h, w, b, k=k), plain_ms,
            library_ms, False),
        "fused_head_topk_int8": (
            lambda: thead.fused_head_topk_int8(h8, w_q, scale, b8, k=k),
            time_ms(lambda: thead.reference_head_topk_int8(
                h8, w_q, scale, b8, k)), library8_ms, True),
    }
    for name, (run, p_ms, l_ms, is_int8) in timings.items():
        ms = time_ms(run)
        results[name].update(
            ms=ms, plain_ms=p_ms, library_ms=l_ms,
            **_head_bound(N, H, V, k, int8=is_int8),
            cuda_launches_per_call=_cuda_kernels(run, ("head_",)),
            achieved_tops=2.0 * N * H * V / (ms * 1e-3) / 1e12)
    results["fused_head_topk_int8"]["library_error"] = library8_error
    results["fused_head_topk_int8"]["thresh_ms"] = time_ms(
        lambda: thead.fused_head_topk_int8(h8, w_q, scale, b8, k=k,
                                           extract="thresh"))
    result = {"phase": "head_variants", "ok": True, "shape": [N, H, V],
              "k": k, "kernels": results,
              "mask_kernel_ms": time_ms(
                  lambda: thead.fused_head_topk(h, w, b, k=k))}
    emit(result)
    return result


def _paper_setup(name="editnet_beam5", sets=None):
    """The named config at paper width, a 9490-word wordmap, and random
    weights from seed 0 written and read back through the .npz bridge."""
    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.data import SyntheticCaptionSource, Vocab
    from captionkit_torch.models import get_model
    from captionkit_torch.params import load_params_npz, save_params_npz

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    cfg = get_named_config(name).override(
        {"decode.batch_size": N_IMAGES, **(sets or {})})
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
    npz = SMOKE_DIR / f"params_{cfg.model.arch}.npz"
    save_params_npz(model.init(0, "cpu"), str(npz))
    params = load_params_npz(str(npz), "cuda", arch=cfg.model.arch)
    torch.cuda.synchronize()
    return cfg, model, params, vocab


def phase_serve(cfg, model, params, vocab, wrappers, expect,
                phase="serve"):
    """Serve a full batch and a flush through ``serve_stream``; every
    wrapper named in ``expect`` must have launched."""
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
    for name in expect:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    result = {"phase": phase, "ok": True, "config": cfg.name,
              "requests": n_req,
              "batches": [N_IMAGES, 8], "wall_s": wall,
              "launches": launches,
              "sample": answers[0]["caption"][:120]}
    emit(result)
    return result


def _batch(mc):
    """The timed 512-image batch (host tensors), from seed 0: features,
    existing captions and their lengths (8 to 22, so many are masked)."""
    import numpy as np
    import torch

    r = np.random.default_rng(0)
    feats = torch.from_numpy(r.standard_normal(
        (N_IMAGES, mc.num_regions, mc.feat_dim)).astype(np.float32))
    existing = torch.from_numpy(
        r.integers(4, mc.vocab_size - 2, (N_IMAGES, MAX_LEN)))
    existing_len = torch.from_numpy(
        r.integers(8, MAX_LEN + 1, (N_IMAGES,)))
    return feats, existing, existing_len


def phase_decode(cfg, model, params, vocab, wrappers, card):
    import dataclasses

    import torch

    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.kernels.head import fused_head_topk
    from captionkit_torch.models import get_model

    mc = cfg.model
    batch = _batch(mc)
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
    steps = _check_steps(model, params, [t.cuda() for t in batch], kw)
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


def _float_plain_head(params, ctx_k, state):
    import torch

    from captionkit_torch.kernels.head import reference_head_topk

    return reference_head_topk(state.h_lang.to(torch.bfloat16),
                               params.fc_w.to(torch.bfloat16), params.fc_b,
                               BEAM)


def _int8_plain_head(params, ctx_k, state):
    from captionkit_torch.kernels.head import reference_head_topk_int8

    return reference_head_topk_int8(state.h_lang, ctx_k.head_w,
                                    ctx_k.head_scale, ctx_k.head_b, BEAM)


def _check_steps(model, params, inputs, kw, plain=_float_plain_head,
                 agree=head_agreement) -> dict:
    """The head kernel against its plain version on the states the decode
    visits: the batch's K hypotheses per image (``all_tokens`` of one
    kernel decode) are fed back step by step, and at each of the 22 steps
    the kernel's (vals, idx, lse) from ``step_topk`` are held against
    ``plain`` on the same hidden state, within the bar of ``agree``.
    ``inputs`` are the encoder's (features, existing, existing_len) on the
    card. Planted faults (a shifted lse on a few rows, ranks 0 and 1
    exchanged) must fail that bar, which shows it would catch them.
    Launches made here are not counted as the main path's."""
    import torch

    from captionkit_torch.decode.beam import beam_search

    feats, existing, existing_len = inputs
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
        for t in range(MAX_LEN):
            state, *got = model.step_topk(params, ctx_k, state, tok, BEAM)
            want = plain(params, ctx_k, state)
            res = agree(got, want)
            check(res["ok"], f"step {t}: kernel vs plain head on the "
                             f"decode's state: {res}")
            worst["idx_agreement"] = min(worst["idx_agreement"],
                                         res["idx_agreement"])
            for key in ("vals_max_abs_err", "lse_max_abs_err"):
                worst[key] = max(worst[key], res[key])
            if t == 0:
                for name, bad in planted_faults(got):
                    faults_caught[name] = not agree(bad, want)["ok"]
            tok = hyps[:, t].contiguous()
    for name, caught in faults_caught.items():
        check(caught, f"planted fault {name} passes the head bar")
    return {"steps": MAX_LEN, "bar": agree.__name__, **worst,
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


# --------------------------------------------------------------------------
# Fused decode cells (kernels/megastep.py)
# --------------------------------------------------------------------------


def _bf16_ulp(x):
    """One bf16 ulp at |x|: x = m 2^e with m in [0.5, 1), ulp = 2^(e-8)."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def cell_agreement(got, want, kinds) -> dict:
    """Max |err| of each output pair and whether all are within the bar:
    "state" outputs (fp32 h, c) within CELL_ATOL and finite; "weights"
    outputs (bf16 α, β, ω) within one bf16 ulp of the larger value (a
    relative 2^-8 to 2^-7): both sides sum the same fp32 terms in other
    orders, so a weight may round to the neighbouring bf16 value, never
    further."""
    import torch

    out = {"max_abs_err": 0.0, "max_ulps": 0.0, "ok": True}
    for g, w, kind in zip(got, want, kinds):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        out["max_abs_err"] = max(out["max_abs_err"], float(d.max()))
        if kind == "state":
            ok = float(d.max()) <= CELL_ATOL and bool(torch.isfinite(g).all())
        else:
            ulps = float((d / _bf16_ulp(torch.maximum(g.abs(),
                                                      w.abs()))).max())
            out["max_ulps"] = max(out["max_ulps"], ulps)
            ok = ulps <= 1.0
        out["ok"] = out["ok"] and ok
    return out


def _swap_if(w, hp):
    """A gate-major [..., 4Hp] tensor with its i and f blocks exchanged."""
    import torch

    i, f, g, o = w.split(hp, dim=-1)
    return torch.cat([f, i, g, o], dim=-1).contiguous()


def _cuda_kernels(fn, keys=("gemm_kernel", "scores_kernel")) -> int:
    """The CUDA kernels whose names hold one of ``keys`` (by default those
    of csrc/megastep.cu) that one call of ``fn`` launches, counted by
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and any(key in ev.key for key in keys))


def _cell_bound(name, N, B, E, H, A, F, R, T) -> dict:
    """The least time the card could take for one call at the function's
    own widths: operations against bytes (each input read once, each output
    written once, at 3.35 TB/s). The bf16 products (989 TFLOP/s, tensor
    cores) and the fp32 attention arithmetic (67 TFLOP/s, CUDA cores) run
    on separate units at once, so the operations take the longer of the
    two. The fp32 work per (row, position, A) term is one add (key + the
    row's q + b, summed once per row) and one multiply-add into the score:
    3 operations. tanh count noted apart (special-function unit)."""
    f4, b2 = 4, 2
    if name == "att_cell":
        mm = 2 * N * (E + 2 * H) * 4 * H + 2 * N * H * 2 * A
        ew = 3 * N * (R + T) * A
        n_in = (N * E * f4 + 3 * N * H * f4 + N * 4 * H * f4
                + (E + 2 * H) * 4 * H * b2 + H * 2 * A * b2 + 4 * A * f4
                + B * (R + T) * A * b2 + B * T * f4)
        n_out = 2 * N * H * f4 + N * (R + T) * b2
        tanh = N * (R + T) * A
    elif name == "lang_cell":
        mm = (2 * N * H * F + 2 * N * (F + 2 * H) * 4 * H
              + 2 * N * (F + 3 * H) * H)
        ew = 0
        n_in = (N * F * f4 + 4 * N * H * f4 + H * F * b2
                + (F + 2 * H) * 4 * H * b2 + (F + 3 * H) * H * b2
                + (F + 5 * H) * f4)
        n_out = 2 * N * H * f4
        tanh = 0
    elif name == "dcnet_score":
        mm = 2 * N * H * A
        ew = 3 * N * T * A
        n_in = (N * H * f4 + H * A * b2 + 2 * A * f4 + B * T * A * b2
                + B * T * f4)
        n_out = N * T * b2
        tanh = N * T * A
    else:  # dcnet_cell
        mm = 2 * N * H * H + 2 * N * (E + 2 * H) * 4 * H
        ew = 0
        n_in = (N * E * f4 + 3 * N * H * f4 + H * H * b2
                + (E + 2 * H) * 4 * H * b2 + 5 * H * f4)
        n_out = 2 * N * H * f4
        tanh = 0
    t_ops = max(mm / PEAK_BF16_FLOPS, ew / PEAK_FP32_FLOPS)
    t_bytes = (n_in + n_out) / PEAK_BYTES
    return {"bf16_gflop": mm / 1e9, "fp32_gflop": ew / 1e9,
            "mbytes": (n_in + n_out) / 1e6, "tanh_m": tanh / 1e6,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _encoded(model, params, mc, k=BEAM):
    """The timed batch encoded on the card, beam-expanded and prepared
    (pack and head) as beam search prepares it."""
    feats, existing, existing_len = (t.cuda() for t in _batch(mc))
    ctx = model.encode(params, feats, existing, existing_len)
    return model.prepare_topk(params, model.beam_expand(ctx, k), k)


def phase_megastep(ed, dc) -> dict:
    """Each cell kernel against its plain version on the card at paper
    shape (N = 2560 rows, bf16 packs from the timed batch, random fp32
    states from seed 11), planted faults, times and bounds."""
    import dataclasses

    import torch

    from captionkit_torch.kernels import megastep as ms
    from captionkit_torch.models import get_model

    def pallas(setup):
        cfg, _, params, _ = setup
        mc = dataclasses.replace(cfg.model, cell_impl="pallas")
        return mc, get_model(mc), params

    mc, model, params = pallas(ed)
    with torch.inference_mode():
        pack = _encoded(model, params, mc).cell_pack
        dmc, dmodel, dparams = pallas(dc)
        dpack = _encoded(dmodel, dparams, dmc).cell_pack
    B, R, _ = pack.vis_keys.shape
    T = pack.scma_keys.shape[1]
    N = B * BEAM
    Hp, Ep = pack.hp, pack.w_emb.shape[0]
    g = torch.Generator().manual_seed(11)
    h_att, c_att, h_lang, c_lang = (
        (torch.randn((N, Hp), generator=g) * 0.5).cuda() for _ in range(4))
    emb = (torch.randn((N, Ep), generator=g) * 0.1).cuda()
    results = {}

    def hold(name, kernel, plain, kinds, faults):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        agree = cell_agreement(got, want, kinds)
        check(agree["ok"], f"{name}: kernel vs plain at paper shape: {agree}")
        caught = {}
        for fault, run in faults:
            bad = cell_agreement(run(), want, kinds)
            caught[fault] = not bad["ok"]
            check(caught[fault], f"{name}: planted fault {fault} passes "
                                 f"the bar: {bad}")
        results[name] = {
            **agree, "planted_faults_caught": caught,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": None,
            "cuda_launches_per_call": _cuda_kernels(kernel)}
        return want

    att_args = (emb, h_att, c_att, h_lang)
    swapped = dataclasses.replace(
        pack, w_att=_swap_if(pack.w_att, Hp), zvb=_swap_if(pack.zvb, Hp))
    no_mask = dataclasses.replace(
        pack, scma_mask=torch.ones_like(pack.scma_mask))
    check(bool((pack.scma_mask == 0).any()), "the batch masks no position")
    att = hold(
        "att_cell",
        lambda: ms.att_cell(pack, *att_args),
        lambda: ms.reference_att_cell(pack, *att_args),
        ("state", "state", "weights", "weights"),
        [("i_f_gates_exchanged",
          lambda: ms.att_cell(swapped, *att_args)),
         ("scma_mask_dropped",
          lambda: ms.att_cell(no_mask, *att_args))])

    vhat_raw = ms._grouped(att[2], pack.features)
    c_star = ms._grouped(att[3], pack.enc_cs)
    lang_args = (vhat_raw, att[0], h_lang, c_lang, c_star)
    swapped = dataclasses.replace(
        pack, lang_w=_swap_if(pack.lang_w, Hp),
        lang_b=_swap_if(pack.lang_b, Hp))
    no_copy = dataclasses.replace(pack, wr=torch.cat(  # c* rows dropped
        [pack.wr[:-Hp], torch.zeros_like(pack.wr[-Hp:])]))
    hold("lang_cell",
         lambda: ms.lang_cell(pack, *lang_args),
         lambda: ms.reference_lang_cell(pack, *lang_args),
         ("state", "state"),
         [("i_f_gates_exchanged", lambda: ms.lang_cell(swapped, *lang_args)),
          ("copy_gate_c_star_rows_dropped",
           lambda: ms.lang_cell(no_copy, *lang_args))])

    dHp, dEp = dpack.hp, dpack.w_emb.shape[0]
    no_mask = dataclasses.replace(dpack, mask=torch.ones_like(dpack.mask))
    omega = hold(
        "dcnet_score",
        lambda: (ms.dcnet_score(dpack, h_att),),
        lambda: (ms.reference_dcnet_score(dpack, h_att),),
        ("weights",),
        [("mask_dropped", lambda: (ms.dcnet_score(no_mask, h_att),))])[0]
    ctx = ms._grouped(omega, dpack.enc_hs)
    cell_args = (emb[:, :dEp], ctx, h_att[:, :dHp], c_att[:, :dHp])
    swapped = dataclasses.replace(
        dpack, dec_w=_swap_if(dpack.dec_w, dHp), b=_swap_if(dpack.b, dHp))
    hold("dcnet_cell",
         lambda: ms.dcnet_cell(dpack, *cell_args),
         lambda: ms.reference_dcnet_cell(dpack, *cell_args),
         ("state", "state"),
         [("i_f_gates_exchanged",
           lambda: ms.dcnet_cell(swapped, *cell_args))])

    dims = dict(N=N, B=B, E=mc.emb_dim, H=mc.hidden_dim, A=mc.att_dim,
                F=mc.feat_dim, R=R, T=T)
    for name, res in results.items():
        res.update(_cell_bound(name, **dims))
        res["achieved_tflops"] = res["bf16_gflop"] / res["ms"]
    result = {"phase": "megastep", "ok": True, "shape": dims,
              "atol_state": CELL_ATOL, "weights_bar": "1 bf16 ulp",
              "kernels": results}
    emit(result)
    return result


def _check_cell_steps(mod, mc, params, ctx_k, hyps, fields, start_id):
    """The fused step against the plain step (``mod._step_hidden`` with
    and without the pack) on the states the decode visits: the batch's K
    hypotheses per image are fed back, and at each of the 22 steps every
    state field is held within STEP_ATOL. Planted faults (c of every 97th
    row + 2 STEP_ATOL; the state rolled by one image) must fail it.
    Launches made here are not counted as the main path's."""
    import torch

    plain_ctx = ctx_k.replace(cell_pack=None)
    state = mod.init_state(params, ctx_k)
    N = hyps.shape[0]
    tok = torch.full((N,), start_id, dtype=torch.int32, device="cuda")
    worst = {f: 0.0 for f in fields}
    caught = {}

    def errors(got, want):
        return {f: float((getattr(got, f) - getattr(want, f)).abs().max())
                for f in fields}

    with torch.inference_mode():
        for t in range(MAX_LEN):
            fused, _ = mod._step_hidden(params, mc, ctx_k, state, tok)
            plain, _ = mod._step_hidden(params, mc, plain_ctx, state, tok)
            err = errors(fused, plain)
            check(max(err.values()) <= STEP_ATOL,
                  f"step {t}: fused vs plain step {err}")
            for f in fields:
                worst[f] = max(worst[f], err[f])
            if t == 0:
                c_field = fields[1]
                shifted = getattr(fused, c_field).clone()
                shifted[::97] += 2 * STEP_ATOL
                rolled = {f: torch.roll(getattr(fused, f), BEAM, dims=0)
                          for f in fields}
                for name, bad in (
                        ("c_shift", fused.__class__(**{
                            **{f: getattr(fused, f) for f in fields},
                            c_field: shifted})),
                        ("rows_of_next_image", fused.__class__(**rolled))):
                    caught[name] = max(errors(bad, plain).values()) \
                        > STEP_ATOL
            state = fused
            tok = hyps[:, t].contiguous()
    for name, ok in caught.items():
        check(ok, f"planted fault {name} passes the steps bar")
    return {"steps": MAX_LEN, "atol": STEP_ATOL, "max_abs_err": worst,
            "planted_faults_caught": caught}


def _timed_decodes(decodes, batch_of, params, runs=3) -> dict:
    """captions/s of each named decode on its batch, ``runs`` times in
    turns (a, b, a, b, ...) in one call; median, runs and spread."""
    out = {name: [] for name in decodes}
    for _ in range(runs):
        for name, fn in decodes.items():
            t0 = time.perf_counter()
            fn(params, *batch_of[name]).cpu()
            out[name].append(N_IMAGES / (time.perf_counter() - t0))
    return {name: {"captions_per_s": statistics.median(r), "runs": r,
                   "spread_pct": 100.0 * (max(r) - min(r))
                   / statistics.median(r)}
            for name, r in out.items()}


def _decode_pair(cfg, model, params, vocab, wrappers, path_names):
    """The forced-full decode of the timed batch with the model as given
    (cell_impl="pallas") and with cell_impl="xla": launches per batch of
    each wrapper on the path (22 each), captions/s of both in turns,
    token agreement, and the pallas decode's hypotheses."""
    import dataclasses

    import torch

    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.decode.beam import beam_search
    from captionkit_torch.models import get_model

    batch = _batch(cfg.model)
    kw = dict(start_id=vocab.start, end_id=-1, pad_id=vocab.pad,
              device="cuda")
    decode = make_decode_fn(model, cfg.decode, **kw)
    plain_model = get_model(dataclasses.replace(cfg.model, cell_impl="xla"))
    plain_decode = make_decode_fn(plain_model, cfg.decode, **kw)
    plain_decode(params, *batch).cpu()  # warm-up
    decode(params, *batch).cpu()
    for w in wrappers:
        w.launches = 0
    tokens = decode(params, *batch).cpu()
    launches = {w.__name__: w.launches for w in wrappers}
    for name in path_names:
        check(launches[name] == MAX_LEN,
              f"{launches[name]} {name} launches for one batch, "
              f"expected {MAX_LEN}")
    check(tuple(tokens.shape) == (N_IMAGES, MAX_LEN),
          f"tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.model.vocab_size)).all()),
          "token ids out of range")
    timed = _timed_decodes({"pallas": decode, "xla": plain_decode},
                           {"pallas": batch, "xla": batch}, params)
    plain = plain_decode(params, *batch).cpu()
    token_agree = float((tokens == plain).float().mean())
    # Both sum the same bf16 products in other orders, so a near-tie may
    # flip and change an image's caption from that step on.
    check(token_agree >= 0.5,
          f"tokens agree with the plain cells on {token_agree} < 0.5")
    with torch.inference_mode():
        feats, existing, existing_len = (t.cuda() for t in batch)
        ctx = model.encode(params, feats, existing, existing_len)
        res = beam_search(model, params, ctx, beam_size=BEAM,
                          start_id=kw["start_id"], end_id=kw["end_id"],
                          pad_id=kw["pad_id"], max_len=MAX_LEN)
        ctx_k = model.prepare_topk(params, model.beam_expand(ctx, BEAM),
                                   BEAM)
    check(ctx_k.cell_pack is not None, "prepare_topk built no cell pack")
    hyps = res.all_tokens.reshape(N_IMAGES * BEAM, MAX_LEN)
    out = {"launches_per_batch": launches,
           "captions_per_s": timed["pallas"]["captions_per_s"],
           "runs": timed["pallas"]["runs"],
           "spread_pct": timed["pallas"]["spread_pct"],
           "xla_cells": timed["xla"],
           "token_agreement": token_agree,
           "row_agreement": float((tokens == plain).all(dim=1).float()
                                  .mean())}
    return out, decode, batch, ctx_k, hyps


def phase_decode_cells(cfg, model, params, vocab, wrappers, card):
    from captionkit_torch.models import editnet

    out, decode, batch, ctx_k, hyps = _decode_pair(
        cfg, model, params, vocab, wrappers,
        ("att_cell", "lang_cell", "fused_head_topk"))
    steps = _check_cell_steps(editnet, cfg.model, params, ctx_k, hyps,
                              ("h_att", "c_att", "h_lang", "c_lang"),
                              vocab.start)
    profile = _profile(lambda: decode(params, *batch).cpu())
    profile["busy_share_of_timed_wall"] = \
        profile["device_ms"] / (1e3 * N_IMAGES / out["captions_per_s"])
    result = {"phase": "decode_cells", "ok": True, "card": card,
              "config": cfg.name, "cell_impl": "pallas", "batch": N_IMAGES,
              "beam": BEAM, "steps": MAX_LEN, **out, "steps_check": steps,
              "profile": profile}
    emit(result)
    return result


def phase_dcnet(setup, wrappers, card):
    from captionkit_torch.models import dcnet

    cfg, model, params, vocab = setup
    serve = phase_serve(cfg, model, params, vocab, wrappers,
                        ("dcnet_score", "dcnet_cell", "fused_head_topk"),
                        phase="dcnet_serve")
    out, decode, batch, ctx_k, hyps = _decode_pair(
        cfg, model, params, vocab, wrappers,
        ("dcnet_score", "dcnet_cell", "fused_head_topk"))
    steps = _check_cell_steps(dcnet, cfg.model, params, ctx_k, hyps,
                              ("h", "c"), vocab.start)
    profile = _profile(lambda: decode(params, *batch).cpu())
    profile["busy_share_of_timed_wall"] = \
        profile["device_ms"] / (1e3 * N_IMAGES / out["captions_per_s"])
    result = {"phase": "dcnet", "ok": True, "card": card,
              "config": cfg.name, "cell_impl": "pallas", "batch": N_IMAGES,
              "beam": BEAM, "steps": MAX_LEN, "serve_launches":
              serve["launches"], **out, "steps_check": steps,
              "profile": profile}
    emit(result)
    return result, serve


def _reset(wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def phase_int8(ed, dc, wrappers, card):
    """The int8 serving path: editnet_beam5 with model.head_quant=int8
    and decode.feed_dtype=int8, served, decoded (beside the float default
    path in turns), its head checked step by step and profiled; then the
    thresh extraction and the sweep on the decode, and dcnet_beam5 served
    with the int8 head."""
    import torch

    from captionkit_torch.data.featquant import (
        dequantize_for_feed,
        feed_to_device,
        quantize_for_feed,
    )
    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.kernels import head as thead
    from captionkit_torch.models import get_model

    cfg, model, params, vocab = ed
    int8 = {"model.head_quant": "int8", "decode.feed_dtype": "int8"}
    cfg8 = cfg.override(int8)
    model8 = get_model(cfg8.model)
    serve = phase_serve(cfg8, model8, params, vocab, wrappers,
                        ("fused_head_topk_int8",), phase="int8_serve")

    feats, existing, existing_len = _batch(cfg.model)
    t0 = time.perf_counter()
    staged = quantize_for_feed(feats.numpy(), "int8")
    host_quantize_ms = 1e3 * (time.perf_counter() - t0)
    batch8 = (staged, existing, existing_len)
    batchf = (feats, existing, existing_len)
    kw = dict(start_id=vocab.start, end_id=-1, pad_id=vocab.pad,
              device="cuda")
    dec8 = make_decode_fn(model8, cfg8.decode, **kw)
    decf = make_decode_fn(model, cfg.decode, **kw)
    decf(params, *batchf).cpu()  # warm-up
    dec8(params, *batch8).cpu()
    _reset(wrappers)
    tokens8 = dec8(params, *batch8).cpu()
    per_batch = {w.__name__: w.launches for w in wrappers}
    check(per_batch["fused_head_topk_int8"] == MAX_LEN,
          f"{per_batch} int8 head launches for one batch, expected "
          f"{MAX_LEN}")
    check(per_batch["fused_head_topk"] == 0, "the int8 decode launched the "
                                             "float head")
    check(tuple(tokens8.shape) == (N_IMAGES, MAX_LEN)
          and bool(((tokens8 >= 0) & (tokens8 < cfg.model.vocab_size)).all()),
          "int8 tokens of the wrong shape or out of range")
    timed = _timed_decodes({"int8": dec8, "float": decf},
                           {"int8": batch8, "float": batchf}, params)
    tokensf = decf(params, *batchf).cpu()
    agree = float((tokens8 == tokensf).float().mean())
    inputs8 = (dequantize_for_feed(feed_to_device(staged, "cuda"), "int8"),
               existing.cuda(), existing_len.cuda())
    steps8 = _check_steps(model8, params, inputs8, kw,
                          plain=_int8_plain_head, agree=int8_agreement)
    prof8 = _profile(lambda: dec8(params, *batch8).cpu())
    proff = _profile(lambda: decf(params, *batchf).cpu())
    for prof, name in ((prof8, "int8"), (proff, "float")):
        prof["busy_share_of_timed_wall"] = prof["device_ms"] / (
            1e3 * N_IMAGES / timed[name]["captions_per_s"])
    # The feed's host->device copy alone (pageable memory, as the decode
    # function makes it), timed with CUDA events: torch.profiler records
    # the copy only in the first profile taken in a process.
    h2d_ms = {name: time_ms(lambda: feed_to_device(feed, "cuda"), iters=5,
                            warm=1)
              for name, feed in (("int8", staged), ("fp32", feats))}

    # head_extract="thresh": the same tokens as "mask", int8 and float.
    thresh = {}
    for name, c, dec_mask, toks, batch in (
            ("int8", cfg8, dec8, tokens8, batch8),
            ("float", cfg, decf, tokensf, batchf)):
        ct = c.override({"model.head_extract": "thresh"})
        dec_t = make_decode_fn(get_model(ct.model), ct.decode, **kw)
        dec_t(params, *batch).cpu()  # warm-up
        _reset(wrappers)
        toks_t = dec_t(params, *batch).cpu()
        thresh[name] = {"launches": {w.__name__: w.launches
                                     for w in wrappers},
                        "tokens_identical": bool(torch.equal(toks_t, toks))}
        check(thresh[name]["tokens_identical"],
              f"{name} head: thresh tokens differ from mask tokens")
    check(thresh["float"]["launches"]["fused_head_topk_thresh"] == MAX_LEN,
          f"float thresh decode: {thresh['float']['launches']}")
    check(thresh["int8"]["launches"]["fused_head_topk_int8"] == MAX_LEN,
          f"int8 thresh decode: {thresh['int8']['launches']}")

    # The single sweep (CAPTIONKIT_HEAD_SWEEP, read at import: set here on
    # the module for one decode and its steps check).
    thead.SWEEP = True
    try:
        decf(params, *batchf).cpu()  # warm-up
        _reset(wrappers)
        toks_sw = decf(params, *batchf).cpu()
        sweep_launches = {w.__name__: w.launches for w in wrappers}
        check(sweep_launches["head_sweep_topk"] == MAX_LEN
              and sweep_launches["fused_head_topk"] == 0,
              f"sweep decode: {sweep_launches}")
        sweep_steps = _check_steps(model, params,
                                   [t.cuda() for t in batchf], kw)
    finally:
        thead.SWEEP = False
    sweep_agree = float((toks_sw == tokensf).float().mean())
    check(sweep_agree >= 0.5, f"sweep tokens agree with the tiled head's "
                              f"on {sweep_agree} < 0.5")

    dcfg, _, dparams, dvocab = dc
    dcfg8 = dcfg.override(int8)
    dserve = phase_serve(dcfg8, get_model(dcfg8.model), dparams, dvocab,
                         wrappers, ("fused_head_topk_int8", "dcnet_score",
                                    "dcnet_cell"), phase="dcnet_int8_serve")
    result = {
        "phase": "int8", "ok": True, "card": card, "config": cfg8.name,
        "sets": int8, "batch": N_IMAGES, "beam": BEAM, "steps": MAX_LEN,
        "launches_per_batch": per_batch,
        "captions_per_s": timed["int8"]["captions_per_s"],
        "runs": timed["int8"]["runs"],
        "spread_pct": timed["int8"]["spread_pct"],
        "float_head_fp32_feed": timed["float"],
        "token_agreement_with_float": agree,
        "row_agreement_with_float": float(
            (tokens8 == tokensf).all(dim=1).float().mean()),
        "host_quantize_ms": host_quantize_ms,
        "feed_mbytes": {"int8": (staged[0].numel() + 4 * staged[1].numel())
                        / 1e6, "fp32": 4 * feats.numel() / 1e6},
        "h2d_ms": h2d_ms,
        "steps_check": steps8, "profile": prof8, "float_profile": proff,
        "thresh": thresh,
        "sweep": {"launches": sweep_launches, "steps_check": sweep_steps,
                  "token_agreement_with_tiled": sweep_agree},
        "dcnet_serve_launches": dserve["launches"],
    }
    emit(result)
    return result, serve


def main() -> int:
    if not (ROOT / "captionkit_torch" / "csrc").is_dir():
        print("chip_smoke.py: no captionkit_torch package beside it",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phase = "device"
    try:
        info = phase_device()
        card = info["nvidia_smi"]
        phase = "build"
        phase_build()
        phase = "head"
        head = phase_head()
        phase = "head_variants"
        variants = phase_head_variants()
        phase = "setup"
        from captionkit_torch.kernels import WRAPPERS

        ed = _paper_setup("editnet_beam5")
        phase = "serve"
        serve = phase_serve(*ed, WRAPPERS, ("fused_head_topk",))
        phase = "decode"
        decode = phase_decode(*ed, WRAPPERS, card)
        phase = "setup_dcnet"
        dc = _paper_setup("dcnet_beam5", {"model.cell_impl": "pallas"})
        phase = "megastep"
        mega = phase_megastep(ed, dc)
        phase = "decode_cells"
        cfg, _, params, vocab = ed
        from captionkit_torch.models import get_model

        cfg_p = cfg.override({"model.cell_impl": "pallas"})
        cells = phase_decode_cells(cfg_p, get_model(cfg_p.model), params,
                                   vocab, WRAPPERS, card)
        phase = "dcnet"
        dcn, dserve = phase_dcnet(dc, WRAPPERS, card)
        phase = "int8"
        int8, iserve = phase_int8(ed, dc, WRAPPERS, card)
    except Exception as e:  # every failed phase ends the run non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    kernels = [{
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
    }]
    # The cell kernels' main-path launches: EditNet's from the
    # decode_cells decode, DCNet's from the dcnet phase's server.
    path_launches = {"att_cell": cells["launches_per_batch"],
                     "lang_cell": cells["launches_per_batch"],
                     "dcnet_score": dserve["launches"],
                     "dcnet_cell": dserve["launches"]}
    per_batch = {"att_cell": cells["launches_per_batch"],
                 "lang_cell": cells["launches_per_batch"],
                 "dcnet_score": dcn["launches_per_batch"],
                 "dcnet_cell": dcn["launches_per_batch"]}
    replaces = {"att_cell": "captionkit/ops/megastep.py:345",
                "lang_cell": "captionkit/ops/megastep.py:426",
                "dcnet_score": "captionkit/ops/megastep.py:587",
                "dcnet_cell": "captionkit/ops/megastep.py:613"}
    for name, res in mega["kernels"].items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "captionkit_torch/csrc/megastep.cu",
            "replaces": replaces[name],
            "launches": path_launches[name][name],
            "launches_per_batch": per_batch[name][name],
            "cuda_launches_per_call": res["cuda_launches_per_call"],
            "check": "ok",
            "max_abs_err": res["max_abs_err"],
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": None,
        })
    # The rest of the head family: thresh from the float thresh decode,
    # the sweep from the sweep decode, int8 from the int8 server.
    family = {
        "fused_head_topk_thresh": (
            "captionkit/ops/head.py:490",
            int8["thresh"]["float"]["launches"]["fused_head_topk_thresh"],
            int8["thresh"]["float"]["launches"]["fused_head_topk_thresh"],
            0.0),
        "head_sweep_topk": (
            "captionkit/ops/head.py:385",
            int8["sweep"]["launches"]["head_sweep_topk"],
            int8["sweep"]["launches"]["head_sweep_topk"],
            max(int8["sweep"]["steps_check"]["vals_max_abs_err"],
                int8["sweep"]["steps_check"]["lse_max_abs_err"])),
        "fused_head_topk_int8": (
            "captionkit/ops/head.py:597",
            iserve["launches"]["fused_head_topk_int8"],
            int8["launches_per_batch"]["fused_head_topk_int8"],
            max(int8["steps_check"]["vals_max_abs_err"],
                int8["steps_check"]["lse_max_abs_err"])),
    }
    for name, (replaces_at, launches, per_batch_n, steps_err) in \
            family.items():
        res = variants["kernels"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": ("captionkit_torch/csrc/head_int8.cu"
                       if name.endswith("int8")
                       else "captionkit_torch/csrc/head_topk.cu"),
            "replaces": replaces_at,
            "launches": launches,
            "launches_per_batch": per_batch_n,
            "cuda_launches_per_call": res["cuda_launches_per_call"],
            "check": "ok",
            "max_abs_err": max(res["vals_max_abs_err"],
                               res["lse_max_abs_err"], steps_err),
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
        })
    emit({"kernels": kernels})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
