#!/usr/bin/env python3
"""Bring-up check of ``captionkit_torch`` on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

1. device   — CUDA present; the card's name and power limit (nvidia-smi).
2. build    — every kernel of ``captionkit_torch/csrc`` built by nvcc;
              the registers, shared memory and spills of the kernels on
              sm90_cell.cuh, of the head kernels on head_sm90.cuh and of
              the bf16 B6 and dcnet_score kernels (query_kernel,
              context_kernel, dcnet_scores_kernel; the full -Xptxas -v
              report in
              build/captionkit_torch/smoke/ptxas.log); the MUFU operations
              a tanhf compiles to (cuobjdump -sass of a probe; the bounds
              charge a tanh the one MUFU.TANH it needs at least).
3. head     — the fused vocab-head kernel against its plain version on the
              card: paper shape (N = 512 images x 5 beams, H = 1024,
              V = 9490) in bf16, and exact-tie patterns across the kernel's
              128-wide vocab tiles; kernel, plain and library times, one
              CUDA launch a call.
   head_variants — the rest of the head family at paper shape and on the
              tie patterns: the thresh extraction bit-equal to the mask
              kernel, the single sweep within the head's bar (ties exact,
              also on both sides of every cluster share boundary; a merge
              that breaks ties to the higher index and a share left out of
              the merge must fail),
              the int8 head's values and ids bit-equal to its plain
              version (lse within 2e-4); the tiled heads (mask, thresh,
              int8) exact on ties at every share boundary, in every tile
              and at the running bar, where a merge that breaks ties to
              the higher id, a share left out and a tile skipped on a max
              equal to the running k-th value must each fail; planted
              faults must fail every bar; kernel, plain, library and
              bound times.
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
              from encoded batches; planted faults must fail the bars
              (among them the gates of two hidden columns crossed and
              att_cell's zvb dropped); DCNet's gated context bit-equal to
              its plain version on ctx values halfway between bf16
              neighbours, and a ctx rounded first must differ; kernel,
              plain and bound times, CUDA launches per call, the device
              time of each launch of att_cell, lang_cell, dcnet_score and
              dcnet_cell (no cell_common.cuh gemm_kernel among them).
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
              int8 heads) and with the single sweep (steps check; its
              captions/s beside the tiled head's, in turns, median of 3);
              and dcnet_beam5 served once with the int8 head.
10. cell_kernels — the dispatch kernels of nn.dispatch (use_pallas=True):
              fused_lstm_cell, fused_copy_lstm_cell and
              fused_additive_attention against their plain versions at the
              greedy step's shapes (512 rows, paper width: DCNet's LSTM,
              EditNet's Copy-LSTM, visual attention and SCMA, DCNet's text
              attention), at examples/bench_cell_kernels.py's shapes (2560
              rows), on unaligned shapes and with prefix lengths 0, 1 and
              22, with planted faults (among them the gates of two hidden
              columns crossed, a lane's partial score left out and a
              thread's 8 context columns written over the next 8); kernel,
              plain, bound and (LSTM: torch.lstm_cell) library times,
              device times from the profiler beside them, and for the
              attention each launch's device time, the call's device span
              and no gemm_kernel launch.
11. greedy  — editnet_greedy and dcnet_greedy at paper width behind
              CaptionServer(batch=512); a forced-full 22-step greedy decode
              (median of 3) beside the same decode with the dispatch sites
              taking the kernels, launches per batch; each dispatch kernel
              against its plain version on the plain decode's own inputs
              at every step.
12. wholestep — editnet_beam5 with cell_impl="wholestep" behind
              CaptionServer(batch=512); fused_lang_head_topk against its
              plain version at paper shape (N = 2560) with planted faults
              and exact ties, timed beside lang_cell + fused_head_topk and
              lang_cell + head_sweep_topk launched apart; a forced-full
              decode (median of 3) beside the pallas decode in turns, 22
              launches a batch each of att_cell and fused_lang_head_topk
              and none of lang_cell and fused_head_topk; the steps check;
              a profile.

13. fp32    — compute_dtype="float32" through every kernel's fp32
              instance (fp32 products on the CUDA cores, TF32 off): each
              kernel against its plain version at its path's shape within
              1e-5 (heads: idx agreement >= 0.999), an operand rounded to
              bf16 must fail; kernel, plain, library and fp32 bound times;
              then the fp32 paths at batch 512 (editnet_beam5 with pallas
              and wholestep cells, dcnet_beam5 pallas, the thresh
              extraction, the single sweep, the int8 head, the greedy
              dispatch decodes), launches per batch of each kernel.
14. beam10  — editnet_beam5 with decode.beam_size=10 (k = 10 > 8): the
              head kernel's decode and its steps check on the decode's own
              states, and the whole-step decode at k = 10 beside pallas,
              with its steps check.
15. wide_head — the single sweep and the tiled bf16 heads, mask and
              thresh (h streamed beside W), and the int8 head (quantized
              rows streamed beside w_qt) at H = 2048 and 4096 against
              their plain versions, a skipped h chunk must fail; the tiled
              heads exact on ties at the wide plan's share boundaries,
              with planted merge faults failing; times.
16. evaluate — a synthetic Karpathy split (5,000 test images) prepared,
              decoded and scored through cli prepare and cli decode.
17. train   — cross-entropy training at xe_train's paper width (batch
              256): a synthetic split (949 train images x 5 captions, 512
              val images) prepared; cli train-xe for one epoch with CIDEr
              validation through the head kernel (launches counted); the
              epoch resumed from step 12 against the uninterrupted run;
              the exported weights decoded by cli decode; the deferred
              backward against autograd on one batch with a planted
              dropped term; ms a step, tokens/s, peak memory, deferred and
              autograd in turns; the loops' prefetched feed against the
              synchronous copy (batches byte-equal, two steps bit-equal,
              ms a step with each and the pinned copy against the
              pageable one, in turns); a profile (``--profile-train``, a
              process of its own), dcnet_xe_train for a few steps; the
              step's bound. The XE and SCST loops take their batches
              through data/prefetch.py.

18. scst    — SCST fine-tuning at scst_train's paper width (batch 256)
              from the train phase's exported XE weights on its split:
              the greedy leg bit-equal to greedy_decode, the native
              rewards within 1e-9 of CiderD, the update's gradients
              against autograd through the plain loop (a dropped lang_wrc
              term and a flipped advantage must fail), ms a step split
              into rollout, reward and update, serial and pipelined in
              turns, peak memory with 1 and 4 samples, cli train-scst
              with validation (launches counted), its export through cli
              decode, dcnet_scst_train, a profile (``--profile-scst``, a
              process of its own).
19. ensemble — editnet_beam5 as a two-member logprob ensemble served at
              batch 512; a forced-full decode (22 launches a batch of
              fused_head_topk at H' = 2048) in turns beside the single
              model; the combined head against its plain version on the
              decode's states; two copies of one checkpoint against the
              single model; the int8, thresh and prob ensembles; the
              stacked DCNet -> EditNet pipeline served and timed (no
              launch in stage 1, 22 head launches a batch in stage 2).
              (wide_head holds the tiled bf16 heads at H = 2048, 4096.)
20. convert — the checkpoint converter and the parity gate at paper
              width: EditNet and DCNet torch twins (seed 0) saved as a
              state dict, as the training dict {epoch, decoder: <module>}
              and with scrambled module names; cli convert of each (the
              last with --fit-names), the .npz array-equal; cli
              parity-gate at fp32 (--max-images 64) with and without
              --fit-names over a 512-image prepared split: ok, greedy
              identical 64 of 64, beam CIDEr through the fp32 head
              kernel; a planted swap of the i and f gate blocks must fail;
              the bf16 gate's token agreement with the twin; wall times.
21. introspect — greedy_decode_with_attention and
              beam_decode_with_attention at batch 512 (editnet_beam5,
              dcnet_greedy, a two-member ensemble): tokens bit-equal to
              the untraced decodes, distributions summing to 1, masked
              positions 0, the ensemble's trace the mean of its members',
              an attention_report, captions/s traced and untraced in
              turns.

Then a {"kernels": [...]} line listing all 12 wrappers, the tiled bf16
heads' wide instances (mask and thresh at H' = 2048) and the 11 fp32
instances (each with its launches on its path, check, ms, plain ms, bound
ms, CUDA launches per call; the fp32 head also with the parity gate's
launches), the nvidia-smi line, and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Kernels are built into build/captionkit_torch/ under the checkout; the
scratch files of the run go to build/captionkit_torch/smoke/.
"""

from __future__ import annotations

import contextlib
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
# Special-function unit: 16 results a clock per SM for 32-bit ex2, rcp,
# rsqrt, lg2, sin, cos (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), 132 SMs at the 1,980 MHz boost clock
# that the fp32 peak above assumes (132 x 128 FMA x 2 x 1.98 GHz).
PEAK_SFU_OPS = 132 * 16 * 1.98e9

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


def _ptxas(log: str) -> dict:
    """{kernel: registers, static shared memory, stack and spill bytes}
    from one source's ``-Xptxas -v`` report, names demangled (c++filt)
    where the machine has it."""
    import re
    import shutil

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m[1]),
                             static_smem=int(smem[1]) if smem else 0)
    if out and shutil.which("c++filt"):
        names = list(out)
        demangled = subprocess.run(
            ["c++filt"], input="\n".join(names), capture_output=True,
            text=True, timeout=60).stdout.splitlines()
        if len(demangled) == len(names):
            out = {d.replace("(anonymous namespace)::", ""): out[n]
                   for n, d in zip(names, demangled)}
    return out


def tanh_sfu_ops() -> dict:
    """The special-function-unit (MUFU) instructions one accurate tanhf
    compiles to for sm_90a with the port's flags: a probe kernel built by
    nvcc into a cubin and read back with cuobjdump -sass (the compiled
    tanhf has no branch: it issues them for every input). The bounds do
    not read it: they charge a tanh one MUFU operation, the MUFU.TANH
    (tanh.approx.f32) a tanh needs at least on sm_90."""
    import re

    from captionkit_torch.kernels import build

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    src, cubin = SMOKE_DIR / "tanh_probe.cu", SMOKE_DIR / "tanh_probe.cubin"
    src.write_text(
        "__global__ void tanh_probe(const float* x, float* y) {\n"
        "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
        "  y[i] = tanhf(x[i]);\n}\n")
    nvcc = build.nvcc()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(cubin), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    mufu = re.findall(r"MUFU\.\w+", sass)
    check(bool(mufu), "cuobjdump shows no MUFU instruction in a tanhf")
    return {"mufu_per_tanhf": len(mufu), "mufu": mufu}


def phase_build():
    """Every source built; each kernel's registers, shared memory and
    spills (the full compiler report goes to SMOKE_DIR/ptxas.log)."""
    from captionkit_torch.kernels import build

    t0 = time.perf_counter()
    logs = {}
    seconds = build.build(reports=logs)
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    (SMOKE_DIR / "ptxas.log").write_text(
        "".join(f"=== {n}.cu\n{log}\n" for n, log in logs.items()))
    # The kernels on sm90_cell.cuh by source (cell_kernel instances and
    # the whole step's lang_head_kernel); every kernel's report is in the
    # log.
    reports = {n: _ptxas(log) for n, log in logs.items()}
    cells = {n: {k: v for k, v in r.items()
                 if "cell_kernel" in k or "lang_head_kernel" in k}
             for n, r in reports.items()}
    # The head kernels on head_sm90.cuh: one instance per operands,
    # epilogue (extraction, list length) and A resident or streamed.
    heads = {n: {k.split("(")[0].replace("void hsm::", ""): v
                 for k, v in r.items() if "hsm::head_kernel" in k}
             for n, r in reports.items()}
    # The bf16 kernels of B6 (its K-split query product and context
    # kernel) and dcnet_score's score kernel.
    scores = {n: {k.split("(")[0].replace("void ", ""): v
                  for k, v in r.items()
                  if any(key in k for key in ("query_kernel", "context_kernel",
                                              "dcnet_scores_kernel"))}
              for n, r in reports.items()}
    tanh = tanh_sfu_ops()
    emit({"phase": "build", "ok": True, "sources": list(build.SOURCES),
          "seconds": time.perf_counter() - t0, "per_source": seconds,
          "sm90_cell_kernels": {n: c for n, c in cells.items() if c},
          "sm90_head_kernels": {n: c for n, c in heads.items() if c},
          "score_kernels": {n: c for n, c in scores.items() if c},
          "tanhf_sass": tanh, "peak_sfu_ops_per_s": PEAK_SFU_OPS})


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
        "device_ms": _device_ms(lambda: fused_head_topk(h, w, b, k=k),
                                ("head_",)),
        "cuda_launches_per_call": _cuda_kernels(
            lambda: fused_head_topk(h, w, b, k=k), ("head_",)),
    }
    emit(result)
    return result


def _int8_inputs(N, H, V, seed):
    """fp32 h on the card (the decode feeds the int8 head fp32 states), the
    head quantized by ``quantize_head`` and the kernel's K-major copy of
    w_q (``kmajor_head``, made once a batch by ``prepare_topk``)."""
    import torch

    from captionkit_torch.kernels.head import kmajor_head, quantize_head

    g = torch.Generator().manual_seed(seed)
    h = torch.randn((N, H), generator=g).cuda()
    w = (torch.randn((H, V), generator=g) * 0.03).cuda()
    b = (torch.randn((V,), generator=g) * 0.01).cuda()
    w_q, scale, b_q = quantize_head(w, b)
    return h, w_q, scale, b_q, kmajor_head(w_q)


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


def _sweep_tie_patterns():
    """(name, h, w, b, k) with exact ties on both sides of every boundary
    between the sweep's cluster shares, as ``sweep_plan`` splits the vocab
    on this card: h is one-hot (row i selects pattern row i mod 16), so
    logits row i is pattern row i mod 16, every value exact in bf16. 16
    rows (one row block: 4 shares) and the paper's 2560 (3 shares), V =
    9600, k = 1, 5, 8."""
    import numpy as np
    import torch

    from captionkit_torch.kernels import head as thead
    from captionkit_torch.kernels.head import TILE_V

    clusters = thead.cluster_table("head_sweep", torch.device("cuda"))
    V, P = 9600, 16
    cases = []
    for N in (16, N_IMAGES * BEAM):
        shares, per = thead.sweep_plan(N, V, clusters)
        cuts = [c * per * TILE_V for c in range(1, shares)
                if c * per * TILE_V < V]
        check(len(cuts) >= 1, f"sweep plan {shares, per} has no boundary")
        rng = np.random.default_rng(N)
        pat = rng.integers(-2, 2, (P, V)).astype(np.float32)
        pat[0] = 1.0  # the whole row ties
        for cut in cuts:
            pat[1, [cut - 1, cut]] = 5.0  # the best pair straddles a cut
            pat[2, [cut - 2, cut + 1]] = 6.0
            pat[3, [cut - 1, cut, 0, V - 1]] = 3.0  # and the row's ends
            pat[5, cut - 4:cut + 4] = 4.0  # a run across the cut
        for c in range(shares):  # an equal best in every share
            pat[4, min(c * per * TILE_V + 5, V - 1)] = 7.0
        h = np.zeros((N, P), np.float32)
        h[np.arange(N), np.arange(N) % P] = 1.0
        for k in (1, 5, 8):
            cases.append((f"{shares}_shares_{N}_rows_k{k}",
                          torch.from_numpy(h).to("cuda", torch.bfloat16),
                          torch.from_numpy(pat).to("cuda", torch.bfloat16),
                          torch.zeros((V,), device="cuda"), k))
    return cases


def _sweep_faults(h, w, b, k):
    """(name, run) of planted faults of the sweep's merge, each through the
    kernel itself: a merge that breaks ties to the higher index (the kernel
    on the vocab reversed, ids mapped back) and a cluster share left out
    (its columns' bias at HEAD_PAD, so they never rank and add nothing)."""
    import torch

    from captionkit_torch.kernels import head as thead

    V = w.shape[1]
    _, per = thead.sweep_plan(h.shape[0], V, thead.cluster_table("head_sweep", h.device))

    def higher_index_first():
        v, i, l = thead.head_sweep_topk(h, w.flip(1).contiguous(),
                                        b.flip(0).contiguous(), k=k)
        return v, (V - 1 - i).to(torch.int32), l

    def share_left_out():
        dropped = b.clone()
        dropped[per * thead.TILE_V:2 * per * thead.TILE_V] = thead.HEAD_PAD
        return thead.head_sweep_topk(h, w, dropped, k=k)

    return [("ties_to_higher_index", higher_index_first),
            ("share_left_out", share_left_out)]


def _tiled_tie_patterns(kernel):
    """(name, h, w, b, k) for a tiled head (``kernel`` "mask", "thresh" or
    "int8") with exact ties on both sides of every boundary between its
    cluster shares on this card, in every 128-wide tile (the walk of a
    share starts at a tile rotated by the row block, so a later-walked tile
    holds a value equal to the running k-th with a lower id) and across
    whole rows: h is one-hot (row i selects pattern row i mod 16). Float:
    integer patterns, exact in bf16; int8: columns copied from a few column
    vectors, so equal columns quantize and dequantize alike (fp32 h, w
    before quantize_head). 16 rows and the paper's 2560, V = 9600, k = 1,
    5, 10."""
    import numpy as np
    import torch

    from captionkit_torch.kernels import head as thead
    from captionkit_torch.kernels.head import TILE_V

    lib = "head_int8" if kernel == "int8" else "head_topk"
    clusters = thead.cluster_table(lib, torch.device("cuda"))
    V, P = 9600, 16
    cases = []
    for N in (16, N_IMAGES * BEAM):
        shares, per = thead.sweep_plan(N, V, clusters)
        cuts = [c * per * TILE_V for c in range(1, shares)
                if c * per * TILE_V < V]
        check(len(cuts) >= 1, f"{kernel} plan {shares, per} has no boundary")
        rng = np.random.default_rng(N)
        if kernel == "int8":
            kinds = rng.standard_normal((P, 7)).astype(np.float32)
            kinds[:, 6] = np.abs(kinds[:, 6]) + 4.0  # the top kind
            kind = rng.integers(0, 6, V)
            kind[[c + d for c in cuts for d in (-1, 0)]] = 6
            kind[np.arange(0, V, TILE_V) + 9] = 6
            pat = kinds[:, kind]
        else:
            pat = rng.integers(-2, 2, (P, V)).astype(np.float32)
            pat[0] = 1.0  # the whole row ties
            for cut in cuts:
                pat[1, [cut - 1, cut]] = 5.0
                pat[2, [cut - 2, cut + 1]] = 6.0
                pat[3, [cut - 1, cut, 0, V - 1]] = 3.0
                pat[5, cut - 4:cut + 4] = 4.0
            for c in range(shares):
                pat[4, min(c * per * TILE_V + 5, V - 1)] = 7.0
            for t in range(V // TILE_V):  # an equal best in every tile
                pat[6, t * TILE_V + 3] = 9.0
                pat[7, t * TILE_V + 126:t * TILE_V + 130] = 2.0
        h = np.zeros((N, P), np.float32)
        h[np.arange(N), np.arange(N) % P] = 1.0
        dt = torch.float32 if kernel == "int8" else torch.bfloat16
        for k in (1, 5, 10):
            cases.append((f"{shares}_shares_{N}_rows_k{k}",
                          torch.from_numpy(h).to("cuda", dt),
                          torch.from_numpy(pat).to("cuda", dt),
                          torch.zeros((V,), device="cuda"), k))
    return cases


def _tiled_run(kernel, h, w, b, k, fault=0):
    """(kernel run, plain run) of a tiled head on float inputs (the int8
    head quantizes w here, ``fault`` as in ``kernels/head.py``)."""
    from captionkit_torch.kernels import head as thead

    if kernel == "int8":
        w_q, scale, b_q = thead.quantize_head(w, b)
        w_qt = thead.kmajor_head(w_q)
        return (lambda: thead._launch_int8(h, w_q, scale, b_q, k, "mask",
                                           w_qt, fault),
                lambda: thead.reference_head_topk_int8(h, w_q, scale, b_q,
                                                       k))
    wrapper = (thead.fused_head_topk if kernel == "mask"
               else thead.fused_head_topk_thresh)
    return (lambda: thead._launch_tiled(h, w, b, k, kernel, wrapper, fault),
            lambda: thead.reference_head_topk(h, w, b, k))


def _tiled_faults(kernel, h, w, b, k):
    """(name, run) of planted faults of a tiled head, each through the
    kernel itself: a merge that breaks ties to the higher id (the kernel on
    the vocab reversed, ids mapped back), a cluster share left out (its
    columns' bias at HEAD_PAD) and a tile skipped when its max equals the
    running k-th value (the kernel's fault switch)."""
    import torch

    from captionkit_torch.kernels import head as thead

    V = w.shape[1]
    lib = "head_int8" if kernel == "int8" else "head_topk"
    _, per = thead.sweep_plan(h.shape[0], V,
                              thead.cluster_table(lib, h.device))

    def higher_id_first():
        v, i, l = _tiled_run(kernel, h, w.flip(1).contiguous(),
                             b.flip(0).contiguous(), k)[0]()
        return v, (V - 1 - i).to(torch.int32), l

    dropped = b.clone()
    dropped[per * thead.TILE_V:2 * per * thead.TILE_V] = thead.HEAD_PAD
    return [("ties_to_higher_id", higher_id_first),
            ("share_left_out", _tiled_run(kernel, h, w, dropped, k)[0]),
            ("tile_skipped_on_an_equal_max",
             _tiled_run(kernel, h, w, b, k, fault=1)[0])]


def _head_bound(N, H, V, k, *, int8: bool, fp32: bool = False) -> dict:
    """Least time of the head at the function's own vocab V: 2 N H V
    products (bf16, int8 or, under ``fp32``, fp32 CUDA-core peak) against
    h, W, scales, bias read once and the outputs written once."""
    ops = 2.0 * N * H * V
    if int8:
        n_bytes = N * H * 4 + H * V + 2 * V * 4 + N * k * 8 + N * 4
        t_ops = ops / PEAK_INT8_OPS
    elif fp32:
        n_bytes = N * H * 4 + H * V * 4 + V * 4 + N * k * 8 + N * 4
        t_ops = ops / PEAK_FP32_FLOPS
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
    h8, w_q, scale, b8, w_qt = _int8_inputs(N, H, V, seed=7)
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
                                          extract=e, w_qt=w_qt)
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
    # The sweep: ties on both sides of every cluster share boundary, exact;
    # its merge faults must fail the exact bar there.
    sweep = results["head_sweep_topk"]
    sweep["share_ties"] = {}
    caught = {"ties_to_higher_index": False, "share_left_out": False}
    for name, th, tw, tb, tk in _sweep_tie_patterns():
        want = thead.reference_head_topk(th, tw, tb, tk)
        got = thead.head_sweep_topk(th, tw, tb, k=tk)
        exact = bool(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]))
        lse_err = float((got[2] - want[2]).abs().max())
        sweep["share_ties"][name] = {"exact": exact, "lse_err": lse_err}
        check(exact and lse_err <= 1e-5,
              f"sweep share-boundary ties {name}: {got[1][:6].tolist()} vs "
              f"{want[1][:6].tolist()}, lse err {lse_err}")
        for fault, bad in _sweep_faults(th, tw, tb, tk):
            v, i, _ = bad()
            if not (torch.equal(v, want[0]) and torch.equal(i, want[1])):
                caught[fault] = True
    # At paper shape the random logits hold no ties, so only the share left
    # out can show there.
    for fault, bad in _sweep_faults(h, w, b, k):
        if fault == "share_left_out":
            caught[f"{fault}_paper_shape"] = not head_agreement(
                bad(), plain)["ok"]
    for fault, ok in caught.items():
        check(ok, f"head_sweep_topk: planted fault {fault} passes the bar")
    sweep["planted_faults_caught"].update(caught)
    # The tiled heads: ties at every share boundary, in every tile and at
    # the running bar, exact (thresh also bit-equal to mask); each planted
    # fault of the one-launch design must fail the exact bar there, and
    # the share left out also at paper shape.
    results["fused_head_topk"] = {"share_ties": {},
                                  "planted_faults_caught": {}}
    for kernel, name in (("mask", "fused_head_topk"),
                         ("thresh", "fused_head_topk_thresh"),
                         ("int8", "fused_head_topk_int8")):
        res = results[name]
        res["share_ties"] = {}
        caught = {}
        lse_atol = INT8_LSE_ATOL if kernel == "int8" else 1e-5
        for case, th, tw, tb, tk in _tiled_tie_patterns(kernel):
            run, plain_run = _tiled_run(kernel, th, tw, tb, tk)
            got, want = run(), plain_run()
            exact = bool(torch.equal(got[0], want[0])
                         and torch.equal(got[1], want[1]))
            lse_err = float((got[2] - want[2]).abs().max())
            if kernel == "thresh":
                exact = exact and bit_agreement(
                    got, _tiled_run("mask", th, tw, tb, tk)[0]())["ok"]
            res["share_ties"][case] = {"exact": exact, "lse_err": lse_err}
            check(exact and lse_err <= lse_atol,
                  f"{name} share/bar ties {case}: {got[1][:6].tolist()} "
                  f"vs {want[1][:6].tolist()}, lse err {lse_err}")
            for fault, bad in _tiled_faults(kernel, th, tw, tb, tk):
                v, i, l = bad()
                if not (torch.equal(v, want[0]) and torch.equal(i, want[1])
                        and float((l - want[2]).abs().max()) <= lse_atol):
                    caught[fault] = True
                caught.setdefault(fault, False)
        lib = "head_int8" if kernel == "int8" else "head_topk"
        _, per = thead.sweep_plan(N, w.shape[1],
                                  thead.cluster_table(lib, h.device))
        cols = slice(per * thead.TILE_V, 2 * per * thead.TILE_V)
        if kernel == "int8":
            dropped = b8.clone()
            dropped[cols] = thead.HEAD_PAD
            bad = thead._launch_int8(h8, w_q, scale, dropped, k, "mask",
                                     w_qt)
            want = plain8
        else:
            dropped = b.clone()
            dropped[cols] = thead.HEAD_PAD
            bad = _tiled_run(kernel, h, w, dropped, k)[0]()
            want = plain
        caught["share_left_out_paper_shape"] = not head_agreement(
            bad, want)["ok"]
        for fault, ok in caught.items():
            check(ok, f"{name}: planted fault {fault} passes the bar")
        res["planted_faults_caught"].update(caught)
        res["clusters"] = list(thead.cluster_table(
            "head_int8" if kernel == "int8" else "head_topk", h.device))
        res["plan"] = list(thead.sweep_plan(N, w.shape[1], res["clusters"]))
    # The launch plan: clusters of s CTAs the card holds (index s), and the
    # shares and tiles per share it gives the paper shape.
    sweep["clusters"] = list(thead.cluster_table("head_sweep", h.device))
    sweep["plan"] = list(thead.sweep_plan(N, w.shape[1], sweep["clusters"]))
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
            lambda: thead.fused_head_topk_int8(h8, w_q, scale, b8, k=k,
                                               w_qt=w_qt),
            time_ms(lambda: thead.reference_head_topk_int8(
                h8, w_q, scale, b8, k)), library8_ms, True),
    }
    library_device_ms = _device_ms(library)
    for name, (run, p_ms, l_ms, is_int8) in timings.items():
        ms = time_ms(run)
        bound = _head_bound(N, H, V, k, int8=is_int8)
        results[name].update(
            ms=ms, plain_ms=p_ms, library_ms=l_ms, **bound,
            bound_share=bound["bound_ms"] / ms,
            device_ms=_device_ms(run, ("head_",)),
            cuda_launches_per_call=_cuda_kernels(run, ("head_",)),
            achieved_tops=2.0 * N * H * V / (ms * 1e-3) / 1e12)
    results["head_sweep_topk"]["library_device_ms"] = library_device_ms
    results["fused_head_topk_int8"]["library_error"] = library8_error
    results["fused_head_topk_int8"]["thresh_ms"] = time_ms(
        lambda: thead.fused_head_topk_int8(h8, w_q, scale, b8, k=k,
                                           extract="thresh", w_qt=w_qt))
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
                phase="serve", decode_fn=None):
    """Serve a full batch and a flush through ``serve_stream``; every
    wrapper named in ``expect`` must have launched. ``decode_fn`` replaces
    the server's decode (the stacked pipeline)."""
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
                           decode_fn=decode_fn, device="cuda")
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


def _float_plain_head(params, ctx_k, state, k=BEAM):
    """The plain head on the decode's h_lang in the pack's head dtype."""
    from captionkit_torch.kernels.head import reference_head_topk

    dt = ctx_k.head_w.dtype
    return reference_head_topk(state.h_lang.to(dt), params.fc_w.to(dt),
                               params.fc_b, k)


def _int8_plain_head(params, ctx_k, state, k=BEAM):
    from captionkit_torch.kernels.head import reference_head_topk_int8

    return reference_head_topk_int8(state.h_lang, ctx_k.head_w,
                                    ctx_k.head_scale, ctx_k.head_b, k)


def _check_steps(model, params, inputs, kw, plain=_float_plain_head,
                 agree=head_agreement, beam=BEAM) -> dict:
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
        res = beam_search(model, params, ctx, beam_size=beam,
                          start_id=kw["start_id"], end_id=kw["end_id"],
                          pad_id=kw["pad_id"], max_len=MAX_LEN)
        hyps = res.all_tokens.reshape(N_IMAGES * beam, MAX_LEN)
        ctx_k = model.prepare_topk(params, model.beam_expand(ctx, beam),
                                   beam)
        state = model.init_state(params, ctx_k)
        tok = torch.full((N_IMAGES * beam,), kw["start_id"],
                         dtype=torch.int32, device="cuda")
        for t in range(MAX_LEN):
            state, *got = model.step_topk(params, ctx_k, state, tok, beam)
            want = plain(params, ctx_k, state, beam)
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
    return {"steps": MAX_LEN, "beam": beam, "bar": agree.__name__, **worst,
            "planted_faults_caught": faults_caught}


def _profile(run, top: int = 12) -> dict:
    """One run under torch.profiler (``utils.profiling.trace``, which
    writes its Chrome trace under SMOKE_DIR/traces): its host wall time,
    the summed time of the activities on the card (kernels, copies; one
    stream, so their sum is the busy time) and the ones that took
    longest."""
    from torch.autograd import DeviceType

    from captionkit_torch.utils.profiling import annotate, trace

    with trace(str(SMOKE_DIR / "traces")) as prof:
        with annotate("chip_smoke.profile"):
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


def _profile_kernels(fn, keys, calls: int = 10) -> dict:
    """{kernel name: (CUDA launches, device ms) of one call of ``fn``} for
    the CUDA kernels whose names hold one of ``keys`` (all when None),
    from torch.profiler over ``calls`` calls after a warm-up: the launches
    it recorded divided by ``calls``, and the mean duration of a recorded
    launch times the launches a call (that count rounded). On the H100
    machine a profiling session after the first of its process can drop
    kernel records, never add one (PERF.md §7), a kernel's records in a
    session or all of them: so three sessions are taken, and each kernel
    keeps the session that recorded the most of its launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or not (
                    keys is None or any(key in ev.key for key in keys)):
                continue
            n = ev.count / calls
            if n > best.get(ev.key, (0.0, 0.0))[0]:
                best[ev.key] = (n, ev.device_time_total / ev.count
                                * max(1, round(n)) / 1e3)
    return best


def _device_span_ms(fn, first: str, last: str, calls: int = 10) -> float:
    """Device time of one call of ``fn`` from the start of its kernel named
    ``first`` to the end of the next kernel named ``last``, the mean over
    the calls of ``calls`` the profiler recorded both of (it now and then
    misses a record). Where a call's launches overlap (a programmatic
    dependent launch starts before its primary ends) the sum of their
    durations counts the overlap twice; the span does not, and it takes
    in the gaps between them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                        for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA)
        start = None
        for t0, t1, name in events:
            if first in name:
                start = t0
            elif last in name and start is not None:
                spans.append(t1 - start)
                start = None
        if len(spans) >= calls // 2:
            break
    check(len(spans) >= calls // 2,
          f"{len(spans)} spans of {first} .. {last} in {calls} calls")
    return statistics.mean(spans) / 1e3


def _profile_calls(fn, keys, calls: int = 10) -> tuple[float, float]:
    """(CUDA launches, device ms) of one call of ``fn``: the sums of
    ``_profile_kernels``."""
    kernels = _profile_kernels(fn, keys, calls).values()
    return sum(n for n, _ in kernels), sum(ms for _, ms in kernels)


def _cuda_kernels(fn, keys=("gemm_kernel", "scores_kernel",
                            "cell_kernel")) -> int:
    """The CUDA kernels whose names hold one of ``keys`` (by default those
    of csrc/megastep.cu) that one call of ``fn`` launches."""
    return round(_profile_calls(fn, keys)[0])


def _device_ms(fn, keys=None) -> float:
    """Device time of one call of ``fn``: the summed durations of its CUDA
    kernels (those whose names hold one of ``keys``; all when None). Unlike
    ``time_ms`` it leaves out the gaps while the host prepares a launch."""
    return _profile_calls(fn, keys)[1]


def _cross_columns(w, hp):
    """A gate-major [..., 4Hp] tensor whose i-gate columns of hidden
    columns 2m and 2m + 1 are exchanged: an LSTM epilogue that reads the
    gates of two hidden columns crossed."""
    w = w.clone()
    i = w[..., :hp]
    w[..., :hp] = i.reshape(*i.shape[:-1], hp // 2, 2).flip(-1).reshape(
        i.shape)
    return w.contiguous()


def _cell_bound(name, N, B, E, H, A, F, R, T, fp32=False,
                t_valid=None) -> dict:
    """The least time the card could take for one call at the function's
    own widths: operations against bytes (each input read once, each output
    written once, at 3.35 TB/s). The bf16 products (989 TFLOP/s, tensor
    cores), the fp32 attention arithmetic (67 TFLOP/s, CUDA cores) and the
    tanh (special-function unit) run on separate units at once, so the
    operations take the longest of the three. Each attended (row,
    position, A) term is one add (key + the row's q + b, summed once per
    row) and one multiply-add into the score: 3 fp32 operations and one
    tanh. ``t_valid``: the attendable (image, caption position) pairs of
    the mask (all B T when None); a masked position needs no key and no
    arithmetic. ``fp32``: weights, keys and the softmax weights in fp32,
    every product on the CUDA cores."""
    f4, b2 = 4, (4 if fp32 else 2)
    K = N // B
    t_valid = B * T if t_valid is None else t_valid
    if name == "att_cell":
        mm = 2 * N * (E + 2 * H) * 4 * H + 2 * N * H * 2 * A
        tanh = N * R * A + K * t_valid * A
        ew = 3 * tanh
        n_in = (N * E * f4 + 3 * N * H * f4 + N * 4 * H * f4
                + (E + 2 * H) * 4 * H * b2 + H * 2 * A * b2 + 4 * A * f4
                + (B * R + t_valid) * A * b2 + B * T * f4)
        n_out = 2 * N * H * f4 + N * (R + T) * b2
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
        tanh = K * t_valid * A
        ew = 3 * tanh
        n_in = (N * H * f4 + H * A * b2 + 2 * A * f4 + t_valid * A * b2
                + B * T * f4)
        n_out = N * T * b2
    else:  # dcnet_cell
        mm = 2 * N * H * H + 2 * N * (E + 2 * H) * 4 * H
        ew = 0
        n_in = (N * E * f4 + 3 * N * H * f4 + H * H * b2
                + (E + 2 * H) * 4 * H * b2 + 5 * H * f4)
        n_out = 2 * N * H * f4
        tanh = 0
    return _ops_bound(mm, ew, n_in + n_out, fp32, tanh)


def _lane_share_dropped(v):
    """The score vector v [A] with columns 0..7 zeroed: the terms of lane
    0's first eight columns, one lane's partial score of a warp's
    reduction over A, left out. It moves the weights only where the keys
    vary across positions, so it is planted on random keys (scale 0.5):
    the models' encoded keys barely do."""
    v = v.clone()
    v[0:8] = 0.0
    return v


def _halfway_bf16(x):
    """x with its low 16 bits set to 0x8000: exactly halfway between two
    neighbouring bf16 values."""
    import torch

    return ((x.view(torch.int32) & -65536) | 0x8000).view(torch.float32)


def _ctx_halfway_check(ms, dpack, cell_args, g) -> dict:
    """dcnet_cell's context gate multiplies the fp32 context unrounded
    and rounds once: with gate_w = 0, a random gate_b (the model's is 0,
    and a gate of 1/2 commutes with rounding) and every ctx value halfway
    between bf16 neighbours, the kernel's part is bit-equal to the plain
    version's bf16(sigmoid(gate_b) * ctx); the same kernel fed ctx rounded
    to bf16 first (what a kernel that rounds ctx before the multiply
    computes) must differ."""
    import dataclasses

    import torch

    emb, ctx, h, c = cell_args
    ctx = _halfway_bf16(torch.randn(ctx.shape, generator=g).to(ctx.device))
    pack = dataclasses.replace(
        dpack, gate_w=torch.zeros_like(dpack.gate_w),
        gate_b=torch.randn(dpack.gate_b.shape, generator=g).to(ctx.device))
    part, want, bad = (torch.empty(ctx.shape, dtype=dpack.dtype,
                                   device=ctx.device) for _ in range(3))
    ms.dcnet_cell(pack, emb, ctx, h, c, part=part)
    ms.reference_dcnet_cell(pack, emb, ctx, h, c, part=want)
    ms.dcnet_cell(pack, emb, ctx.bfloat16().float(), h, c, part=bad)
    check(torch.equal(part, want), "dcnet_cell: part is not bit-equal to "
          "bf16(sigmoid(gate_b) * ctx) on halfway ctx")
    differ = float((bad != want).float().mean())
    check(differ > 0, "dcnet_cell: rounding ctx first passes the halfway "
          "check")
    return {"part_bit_equal": True, "ctx_rounded_first_differs_share":
            differ}


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

    def hold(name, kernel, plain, kinds, faults, launches=None):
        """``launches``: {label: a name key of one of the call's CUDA
        kernels}, whose device times are reported apart; then no
        gemm_kernel (cell_common.cuh's fp32 tile, once also a bf16 wmma
        tile) may run in the call."""
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
        # One profile for the call's device time, its launches and, by
        # name, each launch's share.
        kernels = _profile_kernels(kernel, ("gemm_kernel", "scores_kernel",
                                            "cell_kernel"))
        results[name] = {
            **agree, "planted_faults_caught": caught,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": None,
            "device_ms": sum(ms for _, ms in kernels.values()),
            "cuda_launches_per_call": round(
                sum(n for n, _ in kernels.values()))}
        if launches:
            by = {label: sum(ms for k, (_, ms) in kernels.items() if key in k)
                  for label, key in launches.items()}
            wmma = round(sum(n for k, (n, _) in kernels.items()
                             if "gemm_kernel" in k))
            check(wmma == 0, f"{name}: {wmma} gemm_kernel launches a call")
            check(all(by.values()), f"{name}: a launch missing from the "
                                    f"profile: {by}")
            results[name].update(device_ms_by_launch=by,
                                 gemm_kernel_launches=wmma)
        return want

    att_args = (emb, h_att, c_att, h_lang)
    swapped = dataclasses.replace(
        pack, w_att=_swap_if(pack.w_att, Hp), zvb=_swap_if(pack.zvb, Hp))
    crossed = dataclasses.replace(
        pack, w_att=_cross_columns(pack.w_att, Hp),
        zvb=_cross_columns(pack.zvb, Hp))
    no_zvb = dataclasses.replace(pack, zvb=torch.zeros_like(pack.zvb))
    no_mask = dataclasses.replace(
        pack, scma_mask=torch.ones_like(pack.scma_mask))
    check(bool((pack.scma_mask == 0).any()), "the batch masks no position")
    # The sm90 instances by their epilogue (sm90_cell.cuh's Epi): 4 the
    # att-LSTM with zvb, 3 the query store, 2 / 1 the lang cell's gate and
    # Copy-LSTM, 5 / 0 DCNet's context gate and LSTM.
    att = hold(
        "att_cell",
        lambda: ms.att_cell(pack, *att_args),
        lambda: ms.reference_att_cell(pack, *att_args),
        ("state", "state", "weights", "weights"),
        [("i_f_gates_exchanged",
          lambda: ms.att_cell(swapped, *att_args)),
         ("hidden_columns_crossed",
          lambda: ms.att_cell(crossed, *att_args)),
         ("zvb_dropped", lambda: ms.att_cell(no_zvb, *att_args)),
         ("scma_mask_dropped",
          lambda: ms.att_cell(no_mask, *att_args))],
        {"lstm": "cell_kernel<4,", "query": "cell_kernel<3,",
         "scores": "scores_kernel"})
    by = results["att_cell"]["device_ms_by_launch"]
    results["att_cell"]["scores_share_of_device_ms"] = \
        by["scores"] / sum(by.values())

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
           lambda: ms.lang_cell(no_copy, *lang_args))],
         {"gate": "cell_kernel<2,", "copy_lstm": "cell_kernel<1,"})

    dHp, dEp = dpack.hp, dpack.w_emb.shape[0]
    no_mask = dataclasses.replace(dpack, mask=torch.ones_like(dpack.mask))
    omega = hold(
        "dcnet_score",
        lambda: (ms.dcnet_score(dpack, h_att),),
        lambda: (ms.reference_dcnet_score(dpack, h_att),),
        ("weights",),
        [("mask_dropped", lambda: (ms.dcnet_score(no_mask, h_att),))],
        {"query": "cell_kernel<3,", "scores": "dcnet_scores_kernel"})[0]
    check(results["dcnet_score"]["cuda_launches_per_call"] == 2,
          f"dcnet_score: {results['dcnet_score']['cuda_launches_per_call']} "
          "CUDA launches a call, expected 2")
    # On random keys: the kernel within the bar, and a lane's partial score
    # left out of the warp's reduction over A past it.
    rkeys = dataclasses.replace(dpack, att_keys=(torch.randn(
        dpack.att_keys.shape, generator=g) * 0.5).to(dpack.dtype).cuda())
    want_r = (ms.reference_dcnet_score(rkeys, h_att),)
    agree = cell_agreement((ms.dcnet_score(rkeys, h_att),), want_r,
                           ("weights",))
    bad = cell_agreement((ms.dcnet_score(dataclasses.replace(
        rkeys, att_v=_lane_share_dropped(rkeys.att_v)), h_att),), want_r,
        ("weights",))
    check(agree["ok"] and not bad["ok"],
          f"dcnet_score on random keys: {agree}; lane share left out: {bad}")
    results["dcnet_score"]["random_keys"] = {
        **agree, "planted_faults_caught": {"lane_share_left_out": True}}
    ctx = ms._grouped(omega, dpack.enc_hs)
    cell_args = (emb[:, :dEp], ctx, h_att[:, :dHp], c_att[:, :dHp])
    swapped = dataclasses.replace(
        dpack, dec_w=_swap_if(dpack.dec_w, dHp), b=_swap_if(dpack.b, dHp))
    crossed = dataclasses.replace(
        dpack, dec_w=_cross_columns(dpack.dec_w, dHp),
        b=_cross_columns(dpack.b, dHp))
    hold("dcnet_cell",
         lambda: ms.dcnet_cell(dpack, *cell_args),
         lambda: ms.reference_dcnet_cell(dpack, *cell_args),
         ("state", "state"),
         [("i_f_gates_exchanged",
           lambda: ms.dcnet_cell(swapped, *cell_args)),
          ("hidden_columns_crossed",
           lambda: ms.dcnet_cell(crossed, *cell_args))],
         {"gate": "cell_kernel<5,", "lstm": "cell_kernel<0,"})
    results["dcnet_cell"]["ctx_halfway"] = _ctx_halfway_check(
        ms, dpack, cell_args, g)

    dims = dict(N=N, B=B, E=mc.emb_dim, H=mc.hidden_dim, A=mc.att_dim,
                F=mc.feat_dim, R=R, T=T)
    # The attendable caption positions (a masked one needs no key).
    t_valid = {"att_cell": int((pack.scma_mask > 0).sum()),
               "dcnet_score": int((dpack.mask > 0).sum())}
    for name, res in results.items():
        res.update(_cell_bound(name, **dims, t_valid=t_valid.get(name)))
        res["achieved_tflops"] = res["bf16_gflop"] / res["ms"]
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["device_bound_share"] = res["bound_ms"] / res["device_ms"]
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


def _decode_pair(cfg, model, params, vocab, wrappers, path_names,
                 other="xla", beam=BEAM):
    """The forced-full decode of the timed batch with the model as given
    (its cell_impl) and with cell_impl=``other``: launches per batch of
    each wrapper on the path (22 each), captions/s of both in turns,
    token agreement, and the given model's hypotheses."""
    import dataclasses

    import torch

    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.decode.beam import beam_search
    from captionkit_torch.models import get_model

    batch = _batch(cfg.model)
    kw = dict(start_id=vocab.start, end_id=-1, pad_id=vocab.pad,
              device="cuda")
    decode = make_decode_fn(model, cfg.decode, **kw)
    plain_model = get_model(dataclasses.replace(cfg.model, cell_impl=other))
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
    impl = cfg.model.cell_impl
    timed = _timed_decodes({impl: decode, other: plain_decode},
                           {impl: batch, other: batch}, params)
    plain = plain_decode(params, *batch).cpu()
    token_agree = float((tokens == plain).float().mean())
    # Both sum the same bf16 products in other orders, so a near-tie may
    # flip and change an image's caption from that step on.
    check(token_agree >= 0.5,
          f"tokens agree with cell_impl={other} on {token_agree} < 0.5")
    with torch.inference_mode():
        feats, existing, existing_len = (t.cuda() for t in batch)
        ctx = model.encode(params, feats, existing, existing_len)
        res = beam_search(model, params, ctx, beam_size=beam,
                          start_id=kw["start_id"], end_id=kw["end_id"],
                          pad_id=kw["pad_id"], max_len=MAX_LEN)
        ctx_k = model.prepare_topk(params, model.beam_expand(ctx, beam),
                                   beam)
    check(ctx_k.cell_pack is not None, "prepare_topk built no cell pack")
    hyps = res.all_tokens.reshape(N_IMAGES * beam, MAX_LEN)
    out = {"launches_per_batch": launches,
           "captions_per_s": timed[impl]["captions_per_s"],
           "runs": timed[impl]["runs"],
           "spread_pct": timed[impl]["spread_pct"],
           f"{other}_cells": timed[other],
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

    def dec_sweep(*args):
        thead.SWEEP = True
        try:
            return decf(*args)
        finally:
            thead.SWEEP = False

    # The sweep decode beside the tiled-head decode, in turns.
    sweep_timed = _timed_decodes({"sweep": dec_sweep, "tiled": decf},
                                 {"sweep": batchf, "tiled": batchf}, params)

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
                  "token_agreement_with_tiled": sweep_agree,
                  "timed_in_turns": sweep_timed},
        "dcnet_serve_launches": dserve["launches"],
    }
    emit(result)
    return result, serve


# --------------------------------------------------------------------------
# The cell kernels of nn.dispatch (kernels/lstm.py, kernels/attention.py)
# --------------------------------------------------------------------------

DISPATCH = ("fused_lstm_cell", "fused_copy_lstm_cell",
            "fused_additive_attention")


def _ops_bound(mm, ew, n_bytes, fp32=False, tanh=0) -> dict:
    """The least time of a call: bf16 products on the tensor cores, fp32
    arithmetic on the CUDA cores and ``tanh`` tanh on the special-function
    unit (one MUFU operation each, the least a tanh needs: sm_90's
    MUFU.TANH; separate units, so the longest of the three) against the
    bytes read and written once. ``fp32``: the products too are fp32 on the
    CUDA cores (compute_dtype="float32", no TF32)."""
    if fp32:
        mm, ew = 0, mm + ew
    units = {"tensor cores": mm / PEAK_BF16_FLOPS,
             "CUDA cores": ew / PEAK_FP32_FLOPS,
             "special-function unit": tanh / PEAK_SFU_OPS,
             "bytes": n_bytes / PEAK_BYTES}
    unit = max(units, key=units.get)
    return {"bf16_gflop": mm / 1e9, "fp32_gflop": ew / 1e9,
            "tanh_m": tanh / 1e6,
            "mbytes": n_bytes / 1e6, "bound_ms": 1e3 * units[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit}


def _lstm_bound(N, D, H, copy, fp32=False) -> dict:
    """2 N (D + H) 4H bf16 products (and 2 N (D + 2H) H for the copy
    gate); x, h, c (and c*) read in fp32, the weights in bf16 (fp32 under
    ``fp32``) and the biases in fp32 once, h' and c' written in fp32."""
    wb = 4 if fp32 else 2
    mm = 2 * N * (D + H) * 4 * H
    n_bytes = 4 * N * (D + 2 * H) + wb * (D + H) * 4 * H + 16 * H + 8 * N * H
    if copy:
        mm += 2 * N * (D + 2 * H) * H
        n_bytes += 4 * N * H + wb * (D + 2 * H) * H + 4 * H
    return _ops_bound(mm, 0, n_bytes, fp32)


def _attention_bound(B, P, A, V, Q, n_valid, fp32=False) -> dict:
    """The query product 2 B Q A in bf16; per valid (row, position) 3 A
    fp32 operations and A tanh for the score and 2 V for the context
    (``n_valid`` sums the rows' valid positions: the masked ones need no
    key, value or arithmetic); q (fp32), Wq (bf16), b, v read once, the
    valid keys and values in bf16 (fp32 under ``fp32``), ctx and w written
    in fp32."""
    wb = 4 if fp32 else 2
    mm = 2 * B * Q * A
    ew = n_valid * (3 * A + 2 * V)
    n_bytes = (4 * B * Q + wb * Q * A + 8 * A + wb * n_valid * (A + V)
               + 4 * B + 4 * B * V + 4 * B * P)
    return _ops_bound(mm, ew, n_bytes, fp32, tanh=n_valid * A)


def _wholestep_bound(N, H, F, V, k, fp32=False) -> dict:
    """The lang cell's products (visual gate 2 N H F, base gates 2 N
    (F + 2H) 4H, copy gate 2 N (F + 3H) H) and the head's 2 N H V in bf16;
    v_hat_raw, h_att, c*, h_lang, c_lang read in fp32, the weights in
    bf16 (fp32 under ``fp32``) and the biases in fp32 once, h', c', the
    top-k and lse written."""
    wb = 4 if fp32 else 2
    mm = (2 * N * H * F + 2 * N * (F + 2 * H) * 4 * H
          + 2 * N * (F + 3 * H) * H + 2 * N * H * V)
    n_bytes = (4 * N * F + 16 * N * H + wb * H * F
               + wb * (F + 2 * H) * 4 * H + wb * (F + 3 * H) * H
               + 4 * (F + 5 * H) + wb * H * V + 4 * V + 8 * N * H
               + 8 * N * k + 4 * N)
    return _ops_bound(mm, 0, n_bytes, fp32)


def attention_agreement(got, want) -> dict:
    """(ctx, w) of the attention kernel against its plain version: ctx
    within CELL_ATOL and finite, every weight within one bf16 ulp of its
    magnitude or 1e-4, whichever is larger (fp32 softmaxes of the same
    scores summed in other orders)."""
    import torch

    (c1, w1), (c2, w2) = got, want
    d = (w1 - w2).abs()
    bar = torch.maximum(_bf16_ulp(torch.maximum(w1.abs(), w2.abs())),
                        torch.full_like(d, 1e-4))
    out = {"ctx_max_abs_err": float((c1 - c2).abs().max()),
           "w_max_abs_err": float(d.max()),
           "w_max_err_over_bar": float((d / bar).max())}
    out["max_abs_err"] = max(out["ctx_max_abs_err"], out["w_max_abs_err"])
    out["ok"] = (out["ctx_max_abs_err"] <= CELL_ATOL
                 and out["w_max_err_over_bar"] <= 1.0
                 and bool(torch.isfinite(c1).all()))
    return out


def state_agreement(got, want) -> dict:
    return cell_agreement(got, want, ("state", "state"))


def _hold(name, run, plain, agree, faults=()):
    """One kernel case: the kernel against its plain version within the
    bar of ``agree``; each planted fault (name, run) must fail it."""
    import torch

    got = run()
    want = plain()
    torch.cuda.synchronize()
    res = agree(got, want)
    check(res["ok"], f"{name}: kernel vs plain: {res}")
    caught = {}
    for fault, bad in faults:
        caught[fault] = not agree(bad(), want)["ok"]
        check(caught[fault], f"{name}: planted fault {fault} passes the bar")
    return {**res, "planted_faults_caught": caught}


def phase_cell_kernels(ed, dc) -> dict:
    """B5 and B6 against their plain versions on the card: at the greedy
    step's shapes (512 rows, paper width, the timed batch's encoded
    context and the models' weights), at examples/bench_cell_kernels.py's
    shapes (2560 rows; LSTM input E+F+H = 4096, Copy-LSTM input F+H =
    3072; R = 36, F = 2048, A = 512) and on unaligned shapes, with planted
    faults; kernel, plain, library and bound times at the greedy
    shapes."""
    import torch

    from captionkit_torch.kernels import attention as ka
    from captionkit_torch.kernels import lstm as kl
    from captionkit_torch.models import dcnet as dmod
    from captionkit_torch.models import editnet as emod
    from captionkit_torch.nn.attention import AdditiveAttentionParams
    from captionkit_torch.nn.cells import CopyLSTMParams, LSTMParams

    cfg, model, params, _ = ed
    dcfg, dmodel, dparams, _ = dc
    mc = cfg.model
    E, H, A, F = mc.emb_dim, mc.hidden_dim, mc.att_dim, mc.feat_dim
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(12)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda()

    with torch.inference_mode():
        batch = [t.cuda() for t in _batch(mc)]
        ctx = model.encode(params, *batch)
        dctx = dmodel.encode(dparams, *batch)
    pk, dpk = emod._packed(params, mc), dmod._packed(dparams, dcfg.model)
    N = N_IMAGES
    kw = {"compute_dtype": bf}
    out = {"lstm": {}, "copy_lstm": {}, "attention": {}}

    # B5 at the greedy step: DCNet's decoder LSTM (D = E + H) and
    # EditNet's Copy-LSTM (D = F + H), fp32 inputs as the models give them.
    dec = dparams.decoder
    x, h, c = randn(N, E + H), randn(N, H, scale=0.5), randn(N, H)
    lstm_args = (dec, x, h, c)
    dec_w = dpk["dec_w"]
    out["lstm"]["greedy"] = _hold(
        "fused_lstm_cell greedy",
        lambda: kl.fused_lstm_cell(*lstm_args, packed=dec_w, **kw),
        lambda: kl.reference_lstm_cell(*lstm_args, packed=dec_w, **kw),
        state_agreement,
        [("i_f_gates_exchanged", lambda: kl.fused_lstm_cell(
            *lstm_args, packed=_swap_if(dec_w, H), **kw)),
         ("gates_of_two_columns_crossed", lambda: kl.fused_lstm_cell(
             *lstm_args, packed=_cross_columns(dec_w, H), **kw))])
    lang = params.lang_lstm
    xl, cs = randn(N, F + H), randn(N, H)
    copy_args = (lang, xl, h, c, cs)
    w_base, w_r = pk["lang"]
    no_copy = torch.cat([w_r[:-H], torch.zeros_like(w_r[-H:])])
    out["copy_lstm"]["greedy"] = _hold(
        "fused_copy_lstm_cell greedy",
        lambda: kl.fused_copy_lstm_cell(*copy_args, packed=pk["lang"], **kw),
        lambda: kl.reference_copy_lstm_cell(*copy_args, packed=pk["lang"],
                                            **kw),
        state_agreement,
        [("i_f_gates_exchanged", lambda: kl.fused_copy_lstm_cell(
            *copy_args, packed=(_swap_if(w_base, H), w_r), **kw)),
         ("copy_gate_c_star_rows_dropped", lambda: kl.fused_copy_lstm_cell(
             *copy_args, packed=(w_base, no_copy), **kw)),
         ("gates_of_two_columns_crossed", lambda: kl.fused_copy_lstm_cell(
             *copy_args, packed=(_cross_columns(w_base, H), w_r), **kw))])

    # B6 at the greedy step: EditNet's visual attention and SCMA, DCNet's
    # text attention, one query row per image.
    q = randn(N, H, scale=0.5)
    att_cases = {
        "visual": (params.vis_attention, ctx.vis_keys, ctx.features, None,
                   pk["vis_wq"]),
        "scma": (params.scma, ctx.scma_keys, ctx.enc_cs, ctx.mask,
                 pk["scma_wq"]),
        "dcnet_text": (dparams.attention, dctx.att_keys, dctx.enc_hs,
                       dctx.mask, dpk["att_wq"]),
    }
    check(bool((~ctx.mask).any()), "the batch masks no caption position")
    # Prefix lengths 0, 1 and T in turn at the masked class's shape.
    T = ctx.mask.shape[1]
    lengths = torch.tensor([0, 1, T], device="cuda").repeat(N // 3 + 1)[:N]
    att_cases["lengths_0_1_T"] = (
        params.scma, ctx.scma_keys, ctx.enc_cs,
        torch.arange(T, device="cuda")[None, :] < lengths[:, None],
        pk["scma_wq"])
    for name, (ap, keys, values, mask, wq) in att_cases.items():
        args = (ap, keys, values, q, mask)
        # Planted faults of the kernels' two reductions: a thread's 8
        # context columns written over the next 8, and (on random keys) a
        # lane's partial score left out of the warp's sum over A.
        slid = values.clone()
        slid[..., 8:16] = values[..., 0:8]
        faults = [("values_of_next_row", lambda: ka.fused_additive_attention(
            ap, keys, torch.roll(values, 1, 0), q, mask, w_q=wq, **kw)),
                  ("slice_in_wrong_columns",
                   lambda: ka.fused_additive_attention(
                       ap, keys, slid, q, mask, w_q=wq, **kw))]
        if mask is not None:
            faults.append(("mask_dropped", lambda: ka.fused_additive_attention(
                ap, keys, values, q, None, w_q=wq, **kw)))
        out["attention"][name] = _hold(
            f"fused_additive_attention {name}",
            lambda: ka.fused_additive_attention(*args, w_q=wq, **kw),
            lambda: ka.reference_additive_attention(*args, w_q=wq, **kw),
            attention_agreement, faults)
        no_share = AdditiveAttentionParams(
            w_enc=ap.w_enc, w_q=ap.w_q, v=_lane_share_dropped(ap.v), b=ap.b)
        rk = (torch.randn(keys.shape, generator=g) * 0.5).to(keys.dtype).cuda()
        out["attention"][f"{name}_random_keys"] = _hold(
            f"fused_additive_attention {name} random keys",
            lambda: ka.fused_additive_attention(ap, rk, values, q, mask,
                                                w_q=wq, **kw),
            lambda: ka.reference_additive_attention(ap, rk, values, q, mask,
                                                    w_q=wq, **kw),
            attention_agreement,
            [("lane_share_left_out", lambda: ka.fused_additive_attention(
                no_share, rk, values, q, mask, w_q=wq, **kw))])

    # examples/bench_cell_kernels.py's shapes: 2560 rows.
    M = N * BEAM
    bench_lstm = LSTMParams(wx=randn(E + F + H, 4 * H, scale=H ** -0.5),
                            wh=randn(H, 4 * H, scale=H ** -0.5),
                            b=randn(4 * H, scale=H ** -0.5))
    xb, hb, cb, csb = (randn(M, E + F + H), randn(M, H, scale=0.5),
                       randn(M, H), randn(M, H))
    out["lstm"]["bench"] = _hold(
        "fused_lstm_cell bench",
        lambda: kl.fused_lstm_cell(bench_lstm, xb, hb, cb, **kw),
        lambda: kl.reference_lstm_cell(bench_lstm, xb, hb, cb, **kw),
        state_agreement)
    xlb = randn(M, F + H)
    out["copy_lstm"]["bench"] = _hold(
        "fused_copy_lstm_cell bench",
        lambda: kl.fused_copy_lstm_cell(lang, xlb, hb, cb, csb, **kw),
        lambda: kl.reference_copy_lstm_cell(lang, xlb, hb, cb, csb, **kw),
        state_agreement)
    vis_b = (params.vis_attention, ctx.vis_keys.repeat(BEAM, 1, 1),
             ctx.features.repeat(BEAM, 1, 1), randn(M, H, scale=0.5), None)
    out["attention"]["bench"] = _hold(
        "fused_additive_attention bench",
        lambda: ka.fused_additive_attention(*vis_b, **kw),
        lambda: ka.reference_additive_attention(*vis_b, **kw),
        attention_agreement)

    # Unaligned shapes (the reference's 5 x 48 x 72, and SCMA's class).
    def u(*shape):
        return randn(*shape, scale=0.2)

    small = LSTMParams(wx=u(48, 4 * 72), wh=u(72, 4 * 72), b=u(4 * 72))
    small_copy = CopyLSTMParams(base=small, wrx=u(48, 72), wrh=u(72, 72),
                                wrc=u(72, 72), br=u(72))
    xs, hs, cs_, css = randn(5, 48), randn(5, 72), randn(5, 72), \
        randn(5, 72)
    out["lstm"]["unaligned"] = _hold(
        "fused_lstm_cell unaligned",
        lambda: kl.fused_lstm_cell(small, xs, hs, cs_, **kw),
        lambda: kl.reference_lstm_cell(small, xs, hs, cs_, **kw),
        state_agreement)
    out["copy_lstm"]["unaligned"] = _hold(
        "fused_copy_lstm_cell unaligned",
        lambda: kl.fused_copy_lstm_cell(small_copy, xs, hs, cs_, css, **kw),
        lambda: kl.reference_copy_lstm_cell(small_copy, xs, hs, cs_, css,
                                            **kw),
        state_agreement)
    ap_s = AdditiveAttentionParams(w_enc=u(96, 64), w_q=u(96, 64), v=u(64),
                                   b=u(64))
    lengths = torch.tensor([22, 1, 7, 13, 22, 4], device="cuda")
    mask_s = torch.arange(22, device="cuda")[None, :] < lengths[:, None]
    att_s = (ap_s, randn(6, 22, 64).to(bf), randn(6, 22, 96).to(bf),
             randn(6, 96), mask_s)
    out["attention"]["unaligned"] = _hold(
        "fused_additive_attention unaligned",
        lambda: ka.fused_additive_attention(*att_s, **kw),
        lambda: ka.reference_additive_attention(*att_s, **kw),
        attention_agreement)

    # Times at the greedy step's shapes.
    w_ih = dec_w[:E + H].t().contiguous()
    w_hh = dec_w[E + H:].t().contiguous()
    b_ih = dec.b.to(bf)
    b_hh = torch.zeros_like(b_ih)
    xbf, hbf, cbf = x.to(bf), h.to(bf), c.to(bf)

    def library_lstm():  # one PyTorch call, the same bf16 operands
        return torch.lstm_cell(xbf, (hbf, cbf), w_ih, w_hh, b_ih, b_hh)

    timings = {
        "fused_lstm_cell": (
            lambda: kl.fused_lstm_cell(*lstm_args, packed=dec_w, **kw),
            lambda: kl.reference_lstm_cell(*lstm_args, packed=dec_w, **kw),
            library_lstm, _lstm_bound(N, E + H, H, False),
            ("cell_kernel",)),
        "fused_copy_lstm_cell": (
            lambda: kl.fused_copy_lstm_cell(*copy_args, packed=pk["lang"],
                                            **kw),
            lambda: kl.reference_copy_lstm_cell(*copy_args,
                                                packed=pk["lang"], **kw),
            None, _lstm_bound(N, F + H, H, True), ("cell_kernel",)),
    }
    del att_cases["lengths_0_1_T"]  # checked, not a path's shape
    for name, (ap, keys, values, mask, wq) in att_cases.items():
        n_valid = int(mask.sum()) if mask is not None else \
            N * keys.shape[1]
        timings[f"fused_additive_attention/{name}"] = (
            lambda ap=ap, keys=keys, values=values, mask=mask, wq=wq:
            ka.fused_additive_attention(ap, keys, values, q, mask, w_q=wq,
                                        **kw),
            lambda ap=ap, keys=keys, values=values, mask=mask, wq=wq:
            ka.reference_additive_attention(ap, keys, values, q, mask,
                                            w_q=wq, **kw),
            None,
            _attention_bound(N, keys.shape[1], A, values.shape[2], H,
                             n_valid),
            ("query_kernel", "context_kernel", "gemm_kernel",
             "attention_kernel"))
    times = {}
    for name, (run, plain, library, bound, keys) in timings.items():
        ms = time_ms(run, iters=10)
        times[name] = {
            "ms": ms, "plain_ms": time_ms(plain, iters=5),
            "library_ms": time_ms(library, iters=10) if library else None,
            **bound, "bound_share": bound["bound_ms"] / ms,
            "device_ms": _device_ms(run, keys),
            "library_device_ms": _device_ms(library) if library else None,
            "cuda_launches_per_call": _cuda_kernels(run, keys)}
        if name.startswith("fused_additive_attention"):
            # The bf16 call: the K-split wgmma query product and
            # context_kernel, a programmatic dependent that starts during
            # the product (the span counts the overlap once); no
            # cell_common.cuh tile.
            by = _profile_kernels(run, keys)
            tile = round(sum(n for k, (n, _) in by.items()
                             if "gemm_kernel" in k))
            check(tile == 0 and times[name]["cuda_launches_per_call"] == 2,
                  f"{name}: {by} (expected the query product and "
                  "context_kernel, no gemm_kernel)")
            times[name].update(
                device_ms_by_launch={
                    "query": sum(ms_ for k, (_, ms_) in by.items()
                                 if "query_kernel" in k),
                    "context": sum(ms_ for k, (_, ms_) in by.items()
                                   if "context_kernel" in k)},
                device_span_ms=_device_span_ms(run, "query_kernel",
                                               "context_kernel"),
                gemm_kernel_launches=tile)
    result = {"phase": "cell_kernels", "ok": True, "rows": N,
              "atol_state": CELL_ATOL,
              "weights_bar": "max(1 bf16 ulp, 1e-4)",
              "checks": out, "times": times,
              "library": "torch.lstm_cell on the same bf16 operands"}
    emit(result)
    return result


def _check_dispatch_steps(mod, run, kernels) -> dict:
    """On a plain greedy decode (``run``), each dispatch call site of
    ``mod`` named in ``kernels`` ({getter: (kernel, plain version,
    agree)}) records its inputs as the decode hands them over; the kernel
    and its plain version run on exactly those inputs, within the bar of
    ``agree``, at every step. The decode itself stays plain; the gap of
    each kernel to the model's plain cell is reported beside. Launches
    made here are not counted as the main path's."""
    import torch

    worst, calls, gap = {}, {}, {}
    originals = {getter: getattr(mod, getter) for getter in kernels}

    def spy(getter):
        kernel, reference, agree = kernels[getter]

        def get(use_pallas=False):
            plain_fn = originals[getter](use_pallas)

            def fn(*a, **k):
                out = plain_fn(*a, **k)
                got = kernel(*a, **k)
                res = agree(got, reference(*a, **k))
                check(res["ok"], f"{getter} call {calls.get(getter, 0)}: "
                                 f"kernel vs plain on the decode's inputs: "
                                 f"{res}")
                calls[getter] = calls.get(getter, 0) + 1
                worst[getter] = max(worst.get(getter, 0.0),
                                    res["max_abs_err"])
                gap[getter] = max(gap.get(getter, 0.0), max(
                    float((x - y).abs().max()) for x, y in zip(got, out)))
                return out
            return fn
        return get

    for getter in kernels:
        setattr(mod, getter, spy(getter))
    try:
        with torch.inference_mode():
            run()
    finally:
        for getter, fn in originals.items():
            setattr(mod, getter, fn)
    return {"calls": calls, "max_abs_err": worst,
            "max_abs_gap_to_plain_cell": gap}


def phase_greedy(ed, dc, wrappers, card) -> dict:
    """editnet_greedy and dcnet_greedy at paper width (random weights
    from seed 0 through the .npz bridge): served behind
    CaptionServer(batch=512); a forced-full 22-step greedy decode of the
    timed batch (end id -1), plain cells, beside the same decode with the
    models' dispatch sites taking the cell kernels (``use_pallas=True``),
    captions/s (median of 3, in turns) and launches per batch; then, on
    the plain decode's own per-step inputs, each dispatch kernel against
    its plain version."""
    import dataclasses

    from captionkit_torch.config import get_named_config
    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.kernels import attention as ka
    from captionkit_torch.kernels import lstm as kl
    from captionkit_torch.models import dcnet as dmod
    from captionkit_torch.models import editnet as emod
    from captionkit_torch.models import get_model

    result = {"phase": "greedy", "ok": True, "card": card, "batch": N_IMAGES,
              "steps": MAX_LEN}
    attention = (ka.fused_additive_attention,
                 ka.reference_additive_attention, attention_agreement)
    for name, setup, mod, path in (
            ("editnet_greedy", ed, emod,
             {"get_copy_lstm_cell_fn": (kl.fused_copy_lstm_cell,
                                        kl.reference_copy_lstm_cell,
                                        state_agreement),
              "get_attention_fn": attention}),
            ("dcnet_greedy", dc, dmod,
             {"get_lstm_cell_fn": (kl.fused_lstm_cell,
                                   kl.reference_lstm_cell, state_agreement),
              "get_attention_fn": attention})):
        _, _, params, vocab = setup
        cfg = get_named_config(name).override(
            {"decode.batch_size": N_IMAGES})
        model = get_model(cfg.model)
        serve = phase_serve(cfg, model, params, vocab, wrappers, (),
                            phase=f"{name}_serve")
        kw = dict(start_id=vocab.start, end_id=-1, pad_id=vocab.pad,
                  device="cuda")
        batch = _batch(cfg.model)
        plain = make_decode_fn(model, cfg.decode, **kw)
        mc = cfg.model
        kernel_model = dataclasses.replace(
            model, step=lambda p, c, s, t, mod=mod, mc=mc: mod.step(
                p, mc, c, s, t, use_pallas=True))
        dispatch = make_decode_fn(kernel_model, cfg.decode, **kw)
        plain(params, *batch).cpu()  # warm-up
        dispatch(params, *batch).cpu()
        _reset(wrappers)
        tokens = plain(params, *batch).cpu()
        plain_launches = {w.__name__: w.launches for w in wrappers}
        check(not any(plain_launches.values()),
              f"{name}: the plain greedy decode launched {plain_launches}")
        check(tuple(tokens.shape) == (N_IMAGES, MAX_LEN)
              and bool(((tokens >= 0) & (tokens < mc.vocab_size)).all()),
              f"{name}: tokens of the wrong shape or out of range")
        _reset(wrappers)
        tokens_k = dispatch(params, *batch).cpu()
        per_batch = {w.__name__: w.launches for w in wrappers}
        want = ({"fused_copy_lstm_cell": MAX_LEN,
                 "fused_additive_attention": 2 * MAX_LEN}
                if mod is emod else
                {"fused_lstm_cell": MAX_LEN,
                 "fused_additive_attention": MAX_LEN})
        for kname in DISPATCH:
            check(per_batch[kname] == want.get(kname, 0),
                  f"{name}: {per_batch[kname]} {kname} launches a batch, "
                  f"expected {want.get(kname, 0)}")
        timed = _timed_decodes({"plain": plain, "dispatch": dispatch},
                               {"plain": batch, "dispatch": batch}, params)
        agree = float((tokens == tokens_k).float().mean())
        # The fused attention's weights enter the context unrounded, the
        # plain attention's rounded to bf16, so near-ties may flip.
        check(agree >= 0.5, f"{name}: dispatch tokens agree with the plain "
                            f"decode on {agree} < 0.5")
        greedy_plain = make_decode_fn(model, cfg.decode, **kw)
        steps = _check_dispatch_steps(
            mod, lambda: greedy_plain(params, *batch).cpu(), path)
        n_sites = {"get_copy_lstm_cell_fn": MAX_LEN,
                   "get_lstm_cell_fn": MAX_LEN,
                   "get_attention_fn": MAX_LEN * (2 if mod is emod else 1)}
        for getter, n in steps["calls"].items():
            check(n == n_sites[getter],
                  f"{name}: {getter} checked {n} times, expected "
                  f"{n_sites[getter]}")
        profile = _profile(lambda: plain(params, *batch).cpu())
        profile["busy_share_of_timed_wall"] = profile["device_ms"] / (
            1e3 * N_IMAGES / timed["plain"]["captions_per_s"])
        profile_k = _profile(lambda: dispatch(params, *batch).cpu())
        result[name] = {
            "serve_launches": serve["launches"],
            "captions_per_s": timed["plain"]["captions_per_s"],
            "runs": timed["plain"]["runs"],
            "spread_pct": timed["plain"]["spread_pct"],
            "dispatch_kernels": timed["dispatch"],
            "launches_per_batch": per_batch,
            "token_agreement_dispatch_vs_plain": agree,
            "steps_check": steps, "profile": profile,
            "dispatch_profile": profile_k}
        _reset(wrappers)
    emit(result)
    return result


# --------------------------------------------------------------------------
# The whole-step kernel (kernels/wholestep.py)
# --------------------------------------------------------------------------


def wholestep_agreement(got, want) -> dict:
    """(h', c', vals, idx, lse): h' and c' within CELL_ATOL, the head's
    outputs within the head's bar (``head_agreement``)."""
    out = {f"head_{k}": v for k, v in head_agreement(got[2:], want[2:])
           .items()}
    state = state_agreement(got[:2], want[:2])
    out.update(state_max_abs_err=state["max_abs_err"],
               max_abs_err=max(state["max_abs_err"],
                               out["head_vals_max_abs_err"],
                               out["head_lse_max_abs_err"]),
               ok=state["ok"] and out["head_ok"])
    return out


def _check_wholestep_steps(model, mc, params, ctx_k, hyps, start_id,
                           beam=BEAM) -> dict:
    """The whole step (``step_topk`` with cell_impl="wholestep") against
    the plain step on the states the decode visits: the batch's K
    hypotheses fed back for 22 steps; each state field within STEP_ATOL of
    the plain step's, and the head's outputs against the plain head on the
    whole step's own h_lang within the head's bar. Planted faults (a
    shifted lse, ranks 0 and 1 exchanged, c_lang of every 97th row + 2
    STEP_ATOL) must fail. Launches made here are not counted."""
    import torch

    from captionkit_torch.models import editnet

    plain_ctx = ctx_k.replace(cell_pack=None)
    state = editnet.init_state(params, ctx_k)
    tok = torch.full((hyps.shape[0],), start_id, dtype=torch.int32,
                     device="cuda")
    fields = ("h_att", "c_att", "h_lang", "c_lang")
    worst = {f: 0.0 for f in fields}
    worst.update(idx_agreement=1.0, vals_max_abs_err=0.0,
                 lse_max_abs_err=0.0)
    caught = {}
    with torch.inference_mode():
        for t in range(MAX_LEN):
            ws, *got = model.step_topk(params, ctx_k, state, tok, beam)
            plain, _ = editnet._step_hidden(params, mc, plain_ctx, state, tok)
            err = {f: float((getattr(ws, f) - getattr(plain, f)).abs().max())
                   for f in fields}
            check(max(err.values()) <= STEP_ATOL,
                  f"step {t}: whole step vs plain step {err}")
            want = _float_plain_head(params, ctx_k, ws, beam)
            res = head_agreement(got, want)
            check(res["ok"], f"step {t}: whole-step head vs plain head {res}")
            for f in fields:
                worst[f] = max(worst[f], err[f])
            worst["idx_agreement"] = min(worst["idx_agreement"],
                                         res["idx_agreement"])
            for key in ("vals_max_abs_err", "lse_max_abs_err"):
                worst[key] = max(worst[key], res[key])
            if t == 0:
                for name, bad in planted_faults(got):
                    caught[name] = not head_agreement(bad, want)["ok"]
                shifted = ws.c_lang.clone()
                shifted[::97] += 2 * STEP_ATOL
                caught["c_shift"] = float(
                    (shifted - plain.c_lang).abs().max()) > STEP_ATOL
            state = ws
            tok = hyps[:, t].contiguous()
    for name, ok in caught.items():
        check(ok, f"planted fault {name} passes the whole-step steps bar")
    return {"steps": MAX_LEN, "beam": beam, "atol_state": STEP_ATOL,
            **worst, "planted_faults_caught": caught}


def phase_wholestep(ed, wrappers, card) -> dict:
    """editnet_beam5 with cell_impl="wholestep": served behind
    CaptionServer(batch=512); the kernel against its plain version at
    paper shape (N = 2560) with planted faults and exact ties; a
    forced-full decode (median of 3) beside the ``pallas`` decode in turns;
    22 launches a batch each of att_cell and fused_lang_head_topk, none of
    lang_cell and fused_head_topk; the steps check; the token agreement
    with the pallas decode; and a profile."""
    import dataclasses

    import torch

    from captionkit_torch.kernels import head as thead
    from captionkit_torch.kernels import megastep as ms
    from captionkit_torch.kernels import wholestep as ws
    from captionkit_torch.models import get_model

    cfg, _, params, vocab = ed
    cfg_w = cfg.override({"model.cell_impl": "wholestep"})
    mc = cfg_w.model
    model = get_model(mc)
    serve = phase_serve(cfg_w, model, params, vocab, wrappers,
                        ("att_cell", "fused_lang_head_topk"),
                        phase="wholestep_serve")
    check(serve["launches"]["lang_cell"] == 0
          and serve["launches"]["fused_head_topk"] == 0,
          f"the whole-step server ran the two-program path: "
          f"{serve['launches']}")

    with torch.inference_mode():
        ctx_k = _encoded(model, params, mc)
    pack, head_w, head_b = ctx_k.cell_pack, ctx_k.head_w, ctx_k.head_b
    N, H = N_IMAGES * BEAM, mc.hidden_dim
    g = torch.Generator().manual_seed(11)
    h_att, c_att, h_lang, c_lang = (
        (torch.randn((N, H), generator=g) * 0.5).cuda() for _ in range(4))
    emb = (torch.randn((N, mc.emb_dim), generator=g) * 0.1).cuda()
    with torch.inference_mode():
        h2, _, vhat_raw, c_star = ms.att_phase(pack, h_att, c_att, h_lang,
                                               emb)
    args = (pack, vhat_raw, h2, c_star, h_lang, c_lang, head_w, head_b)
    swapped = dataclasses.replace(
        pack, lang_w=_swap_if(pack.lang_w, pack.hp),
        lang_b=_swap_if(pack.lang_b, pack.hp))

    def kernel():
        return ws.fused_lang_head_topk(*args, k=BEAM)

    def plain():
        return ws.reference_lang_head_topk(*args, k=BEAM)

    got = kernel()
    faults = [(f, lambda bad=bad: (*got[:2], *bad))
              for f, bad in planted_faults(got[2:])]
    faults.append(("i_f_gates_exchanged", lambda: ws.fused_lang_head_topk(
        swapped, *args[1:], k=BEAM)))
    held = _hold("fused_lang_head_topk", kernel, plain,
                   wholestep_agreement, faults)

    # Exact ties: a head whose second half repeats its first half gives
    # every logit twice; the kernel must rank each pair lowest id first.
    half = head_w.shape[1] // 2 // thead.TILE_V * thead.TILE_V
    tie_w = torch.cat([head_w[:, :half], head_w[:, :half]], 1).contiguous()
    tie_b = torch.cat([head_b[:half], head_b[:half]]).contiguous()
    tie = ws.fused_lang_head_topk(*args[:6], tie_w, tie_b, k=4)
    tie_ref = ws.reference_lang_head_topk(*args[:6], tie_w, tie_b, k=4)
    pairs = bool(torch.equal(tie[3][:, 1], tie[3][:, 0] + half)
                 and torch.equal(tie[3][:, 3], tie[3][:, 2] + half)
                 and torch.equal(tie[2][:, 0], tie[2][:, 1]))
    tie_agree = float((tie[3] == tie_ref[3]).float().mean())
    check(pairs and tie_agree >= 0.999,
          f"whole-step ties: pairs in id order {pairs}, agreement "
          f"{tie_agree}")

    hl_p, cl_p, head_w_p = ws._padded(pack, h_lang, c_lang, head_w)

    def two_programs():  # the pallas path's lang cell, then its head
        hl, _ = ms.lang_cell(pack, vhat_raw, h2, hl_p, cl_p, c_star)
        return thead.fused_head_topk(hl.to(torch.bfloat16), head_w_p,
                                     head_b, k=BEAM)

    def lang_then_sweep():  # the same two steps apart: lang cell + sweep
        hl, _ = ms.lang_cell(pack, vhat_raw, h2, hl_p, cl_p, c_star)
        return thead.head_sweep_topk(hl.to(torch.bfloat16), head_w_p,
                                     head_b, k=BEAM)

    bound = _wholestep_bound(N, H, mc.feat_dim, mc.vocab_size, BEAM)
    ms_call = time_ms(kernel, iters=10)
    dev_ms = _device_ms(kernel, ("lang_head_kernel",))
    timing = {"ms": ms_call, "device_ms": dev_ms,
              "plain_ms": time_ms(plain, iters=5), "library_ms": None,
              "two_programs_ms": time_ms(two_programs, iters=10),
              "two_programs_device_ms": _device_ms(two_programs),
              "lang_cell_then_sweep_ms": time_ms(lang_then_sweep, iters=10),
              "lang_cell_then_sweep_device_ms": _device_ms(lang_then_sweep),
              **bound, "bound_share": bound["bound_ms"] / ms_call,
              "device_bound_share": bound["bound_ms"] / dev_ms,
              "cuda_launches_per_call": _cuda_kernels(
                  kernel, ("gemm_kernel", "lang_head_kernel")),
              "two_programs_cuda_launches": _cuda_kernels(two_programs, None),
              "lang_cell_then_sweep_cuda_launches": _cuda_kernels(
                  lang_then_sweep, None),
              "achieved_tflops": bound["bf16_gflop"] / ms_call,
              "launch": ws.launch_info(0)}
    check(timing["cuda_launches_per_call"] == 1,
          f"the whole step takes {timing['cuda_launches_per_call']} "
          "CUDA launches a call, not 1")

    out, decode, batch, ctx_d, hyps = _decode_pair(
        cfg_w, model, params, vocab, wrappers,
        ("att_cell", "fused_lang_head_topk"), other="pallas")
    per_batch = out["launches_per_batch"]
    check(per_batch["lang_cell"] == 0 and per_batch["fused_head_topk"] == 0,
          f"the whole-step decode ran the two-program path: {per_batch}")
    steps = _check_wholestep_steps(model, mc, params, ctx_d, hyps,
                                   vocab.start)
    profile = _profile(lambda: decode(params, *batch).cpu())
    profile["busy_share_of_timed_wall"] = \
        profile["device_ms"] / (1e3 * N_IMAGES / out["captions_per_s"])
    result = {"phase": "wholestep", "ok": True, "card": card,
              "config": cfg.name, "cell_impl": "wholestep",
              "batch": N_IMAGES, "beam": BEAM, "steps": MAX_LEN,
              "serve_launches": serve["launches"], "kernel": {
                  **held, **timing, "ties": {"pairs_in_id_order": pairs,
                                               "idx_agreement": tie_agree}},
              **out, "steps_check": steps, "profile": profile}
    emit(result)
    return result


# --------------------------------------------------------------------------
# compute_dtype="float32", beam widths above 8, wide heads
# --------------------------------------------------------------------------

F32_ATOL = 1e-5  # fp32 products summed in another order
F32_SETS = {"model.compute_dtype": "float32"}


def f32_agreement(got, want) -> dict:
    """An fp32 instance against its plain version: every float output
    within F32_ATOL and finite, integer outputs (top-k ids) agreeing on
    >= 0.999 of their entries."""
    import torch

    errs, idx = [], 1.0
    finite = True
    for g, w in zip(got, want):
        if g.dtype in (torch.int32, torch.int64):
            idx = min(idx, float((g == w).float().mean()))
        else:
            errs.append(float((g.float() - w.float()).abs().max()))
            finite = finite and bool(torch.isfinite(g).all())
    out = {"max_abs_err": max(errs), "idx_agreement": idx}
    out["ok"] = out["max_abs_err"] <= F32_ATOL and idx >= 0.999 and finite
    return out


def _count_decode(cfg, model, params, vocab, wrappers, sweep=False):
    """One forced-full decode of the timed batch (after a warm-up): the
    wrappers' launches and the tokens. ``sweep`` sets the single-sweep
    flag on the head module for the decode."""
    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.kernels import head as thead

    batch = _batch(cfg.model)
    decode = make_decode_fn(model, cfg.decode, start_id=vocab.start,
                            end_id=-1, pad_id=vocab.pad, device="cuda")
    thead.SWEEP = sweep
    try:
        decode(params, *batch).cpu()
        _reset(wrappers)
        tokens = decode(params, *batch).cpu()
    finally:
        thead.SWEEP = False
    launches = {w.__name__: w.launches for w in wrappers}
    check(tuple(tokens.shape) == (N_IMAGES, MAX_LEN)
          and bool(((tokens >= 0) & (tokens < cfg.model.vocab_size)).all()),
          "tokens of the wrong shape or out of range")
    return launches, tokens


def phase_fp32(ed, dc, wrappers, card) -> dict:
    """compute_dtype="float32" through every kernel's fp32 instance (fp32
    products on the CUDA cores; TF32 is off): each kernel against its
    plain version at its path's shape within F32_ATOL (heads: idx
    agreement >= 0.999), an operand rounded to bf16 (a planted fault) must
    fail that bar; kernel, plain, library and fp32 bound times. Then the
    fp32 paths at batch 512: editnet_beam5 with cell_impl="pallas" and
    "wholestep" (beside the fp32 xla and pallas decodes), dcnet_beam5
    pallas, the thresh extraction, the single sweep, the int8 head, and
    the greedy dispatch decodes (B5, B6); launches per batch of each."""
    import dataclasses

    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.decode import make_decode_fn
    from captionkit_torch.kernels import attention as ka
    from captionkit_torch.kernels import head as thead
    from captionkit_torch.kernels import lstm as kl
    from captionkit_torch.kernels import megastep as ms
    from captionkit_torch.kernels import wholestep as ws
    from captionkit_torch.models import dcnet as dmod
    from captionkit_torch.models import editnet as emod
    from captionkit_torch.models import get_model
    from captionkit_torch.nn.attention import AdditiveAttentionParams

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain fp32 versions would not be fp32")
    kernels = {}

    def case(name, run, plain, library, bound, keys, faults):
        res = _hold(f"{name} fp32", run, plain, f32_agreement, faults)
        ms_ = time_ms(run, iters=5)
        kernels[name] = {
            **res, "ms": ms_, "plain_ms": time_ms(plain, iters=3),
            "library_ms": time_ms(library, iters=5) if library else None,
            **bound, "bound_share": bound["bound_ms"] / ms_,
            "device_ms": _device_ms(run, keys),
            "cuda_launches_per_call": _cuda_kernels(run, keys)}

    # The heads at paper shape.
    N, H, V, k = N_IMAGES * BEAM, 1024, 9490, BEAM
    g = torch.Generator().manual_seed(7)
    h = torch.randn((N, H), generator=g).cuda()
    w = (torch.randn((H, V), generator=g) * 0.03).cuda()
    b = (torch.randn((V,), generator=g) * 0.01).cuda()
    w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.float32)
    h16 = h.bfloat16().float()

    def library_head():  # torch.matmul (fp32, TF32 off) + topk + logsumexp
        logits = torch.matmul(h, w) + b
        return torch.topk(logits, k).values, torch.logsumexp(logits, 1)

    heads = {"fused_head_topk": thead.fused_head_topk,
             "fused_head_topk_thresh": thead.fused_head_topk_thresh,
             "head_sweep_topk": thead.head_sweep_topk}
    for name, fn in heads.items():
        case(name, lambda fn=fn: fn(h, w_p, b_p, k=k),
             lambda: thead.reference_head_topk(h, w_p, b_p, k), library_head,
             _head_bound(N, H, V, k, int8=False, fp32=True), ("head_",),
             [("operand_rounded_to_bf16",
               lambda fn=fn: fn(h16, w_p, b_p, k=k))])

    # The cells at paper shape, on fp32 packs from the timed batch.
    cfg, _, params, vocab = ed
    dcfg, _, dparams, dvocab = dc

    def packed(setup_cfg, p):
        mc = dataclasses.replace(setup_cfg.model, cell_impl="pallas",
                                 compute_dtype="float32")
        with torch.inference_mode():
            return mc, _encoded(get_model(mc), p, mc)

    mc, ctx_k = packed(cfg, params)
    pack = ctx_k.cell_pack
    dmc, dctx_k = packed(dcfg, dparams)
    dpack = dctx_k.cell_pack
    check(pack.dtype == torch.float32 and dpack.dtype == torch.float32,
          "compute_dtype=float32 built a bf16 pack")
    B, R, _ = pack.vis_keys.shape
    T = pack.scma_keys.shape[1]
    Hp, Ep = pack.hp, pack.w_emb.shape[0]
    g = torch.Generator().manual_seed(11)
    h_att, c_att, h_lang, c_lang = (
        (torch.randn((N, Hp), generator=g) * 0.5).cuda() for _ in range(4))
    emb = (torch.randn((N, Ep), generator=g) * 0.1).cuda()
    r16 = lambda x: x.bfloat16().float()  # noqa: E731
    dims = dict(N=N, B=B, E=mc.emb_dim, H=mc.hidden_dim, A=mc.att_dim,
                F=mc.feat_dim, R=R, T=T)
    keys = ("gemm_kernel", "scores_kernel")
    att_args = (emb, h_att, c_att, h_lang)
    case("att_cell", lambda: ms.att_cell(pack, *att_args),
         lambda: ms.reference_att_cell(pack, *att_args), None,
         _cell_bound("att_cell", **dims, fp32=True,
                     t_valid=int((pack.scma_mask > 0).sum())), keys,
         [("operand_rounded_to_bf16", lambda: ms.att_cell(
             pack, emb, r16(h_att), c_att, h_lang))])
    with torch.inference_mode():
        h2, _, alpha, beta = ms.reference_att_cell(pack, *att_args)
        vhat_raw = ms._grouped(alpha, pack.features)
        c_star = ms._grouped(beta, pack.enc_cs)
    lang_args = (vhat_raw, h2, h_lang, c_lang, c_star)
    case("lang_cell", lambda: ms.lang_cell(pack, *lang_args),
         lambda: ms.reference_lang_cell(pack, *lang_args), None,
         _cell_bound("lang_cell", **dims, fp32=True), keys,
         [("operand_rounded_to_bf16", lambda: ms.lang_cell(
             pack, r16(vhat_raw), *lang_args[1:]))])
    dHp, dEp = dpack.hp, dpack.w_emb.shape[0]
    # (A query rounded to bf16 moves the 22-position softmax by less than
    # F32_ATOL here, so the score kernel's planted fault is the mask.)
    no_mask = dataclasses.replace(dpack, mask=torch.ones_like(dpack.mask))
    case("dcnet_score", lambda: (ms.dcnet_score(dpack, h_att[:, :dHp]),),
         lambda: (ms.reference_dcnet_score(dpack, h_att[:, :dHp]),), None,
         _cell_bound("dcnet_score", **dims, fp32=True,
                     t_valid=int((dpack.mask > 0).sum())), keys,
         [("mask_dropped",
           lambda: (ms.dcnet_score(no_mask, h_att[:, :dHp]),))])
    with torch.inference_mode():
        omega = ms.reference_dcnet_score(dpack, h_att[:, :dHp])
        dctx = ms._grouped(omega, dpack.enc_hs)
    cell_args = (emb[:, :dEp], dctx, h_att[:, :dHp], c_att[:, :dHp])
    case("dcnet_cell", lambda: ms.dcnet_cell(dpack, *cell_args),
         lambda: ms.reference_dcnet_cell(dpack, *cell_args), None,
         _cell_bound("dcnet_cell", **dims, fp32=True), keys,
         [("operand_rounded_to_bf16", lambda: ms.dcnet_cell(
             dpack, emb[:, :dEp], r16(dctx), *cell_args[2:]))])

    # The whole step at paper shape.
    w_h, b_h = thead.prepad_head(params.fc_w, params.fc_b,
                                 compute_dtype=torch.float32)
    H1 = mc.hidden_dim
    ws_args = (pack, vhat_raw, h2, c_star, h_lang[:, :H1].contiguous(),
               c_lang[:, :H1].contiguous(), w_h, b_h)
    case("fused_lang_head_topk",
         lambda: ws.fused_lang_head_topk(*ws_args, k=k),
         lambda: ws.reference_lang_head_topk(*ws_args, k=k), None,
         _wholestep_bound(N, H1, mc.feat_dim, mc.vocab_size, k, fp32=True),
         ("gemm_kernel", "head_"),
         [("operand_rounded_to_bf16", lambda: ws.fused_lang_head_topk(
             pack, r16(vhat_raw), *ws_args[2:], k=k))])

    # B5 and B6 at the greedy step's shapes (512 rows), the models' weights.
    G = N_IMAGES
    dec = dparams.decoder
    D = dec.wx.shape[0]
    x = (torch.randn((G, D), generator=g) * 0.5).cuda()
    hg, cg_, csg = ((torch.randn((G, H), generator=g) * 0.5).cuda()
                    for _ in range(3))
    kw = dict(compute_dtype=torch.float32)
    w_ih, w_hh = dec.wx.t().contiguous(), dec.wh.t().contiguous()
    zb = torch.zeros_like(dec.b)
    case("fused_lstm_cell", lambda: kl.fused_lstm_cell(dec, x, hg, cg_, **kw),
         lambda: kl.reference_lstm_cell(dec, x, hg, cg_, **kw),
         lambda: torch.lstm_cell(x, (hg, cg_), w_ih, w_hh, dec.b, zb),
         _lstm_bound(G, D, H, False, fp32=True), ("gemm_kernel",),
         [("operand_rounded_to_bf16", lambda: kl.fused_lstm_cell(
             dec, r16(x), hg, cg_, **kw))])
    lang = params.lang_lstm
    Dc = lang.base.wx.shape[0]
    xc = (torch.randn((G, Dc), generator=g) * 0.5).cuda()
    case("fused_copy_lstm_cell",
         lambda: kl.fused_copy_lstm_cell(lang, xc, hg, cg_, csg, **kw),
         lambda: kl.reference_copy_lstm_cell(lang, xc, hg, cg_, csg, **kw),
         None, _lstm_bound(G, Dc, H, True, fp32=True), ("gemm_kernel",),
         [("operand_rounded_to_bf16", lambda: kl.fused_copy_lstm_cell(
             lang, r16(xc), hg, cg_, csg, **kw))])
    va = params.vis_attention
    P, A, Vf = mc.num_regions, mc.att_dim, mc.feat_dim
    keys_a = (torch.randn((G, P, A), generator=g) * 0.5).cuda()
    values = torch.randn((G, P, Vf), generator=g).cuda()
    q = torch.randn((G, H), generator=g).cuda()
    case("fused_additive_attention",
         lambda: ka.fused_additive_attention(va, keys_a, values, q, None,
                                             **kw),
         lambda: ka.reference_additive_attention(va, keys_a, values, q, None,
                                                 **kw),
         None, _attention_bound(G, P, A, Vf, H, G * P, fp32=True),
         ("gemm_kernel", "attention_kernel"),
         [("operand_rounded_to_bf16", lambda: ka.fused_additive_attention(
             va, keys_a, r16(values), q, None, **kw))])

    # The fp32 paths at batch 512: launches of each kernel a batch.
    paths = {}
    cfg_p = cfg.override({**F32_SETS, "model.cell_impl": "pallas"})
    out_p, *_ = _decode_pair(cfg_p, get_model(cfg_p.model), params, vocab,
                             wrappers, ("att_cell", "lang_cell",
                                        "fused_head_topk"))
    paths["editnet_beam5_pallas"] = out_p
    cfg_w = cfg.override({**F32_SETS, "model.cell_impl": "wholestep"})
    out_w, *_ = _decode_pair(cfg_w, get_model(cfg_w.model), params, vocab,
                             wrappers, ("att_cell", "fused_lang_head_topk"),
                             other="pallas")
    paths["editnet_beam5_wholestep"] = out_w
    dcfg_p = dcfg.override({**F32_SETS, "model.cell_impl": "pallas"})
    out_d, *_ = _decode_pair(dcfg_p, get_model(dcfg_p.model), dparams,
                             dvocab, wrappers, ("dcnet_score", "dcnet_cell",
                                                "fused_head_topk"))
    paths["dcnet_beam5_pallas"] = out_d
    cfg_x = cfg.override(F32_SETS)
    model_x = get_model(cfg_x.model)
    for name, sets, sweep, want in (
            ("thresh", {"model.head_extract": "thresh"}, False,
             "fused_head_topk_thresh"),
            ("sweep", {}, True, "head_sweep_topk"),
            ("int8", {"model.head_quant": "int8"}, False,
             "fused_head_topk_int8")):
        c = cfg_x.override(sets)
        launches, _ = _count_decode(c, get_model(c.model), params, vocab,
                                    wrappers, sweep=sweep)
        check(launches[want] == MAX_LEN,
              f"fp32 {name} decode: {launches}")
        paths[f"editnet_beam5_{name}"] = {"launches_per_batch": launches}
    for name, setup, mod, want in (
            ("editnet_greedy", ed, emod,
             {"fused_copy_lstm_cell": MAX_LEN,
              "fused_additive_attention": 2 * MAX_LEN}),
            ("dcnet_greedy", dc, dmod,
             {"fused_lstm_cell": MAX_LEN,
              "fused_additive_attention": MAX_LEN})):
        _, _, p, voc = setup
        gcfg = get_named_config(name).override(
            {"decode.batch_size": N_IMAGES, **F32_SETS})
        gmc = gcfg.model
        gmodel = get_model(gmc)
        kmodel = dataclasses.replace(
            gmodel, step=lambda pp, c, st, t, mod=mod, gmc=gmc: mod.step(
                pp, gmc, c, st, t, use_pallas=True))
        kwd = dict(start_id=voc.start, end_id=-1, pad_id=voc.pad,
                   device="cuda")
        batch = _batch(gmc)
        plain = make_decode_fn(gmodel, gcfg.decode, **kwd)
        dispatch = make_decode_fn(kmodel, gcfg.decode, **kwd)
        plain(p, *batch).cpu()
        dispatch(p, *batch).cpu()
        _reset(wrappers)
        tokens = dispatch(p, *batch).cpu()
        per_batch = {w_.__name__: w_.launches for w_ in wrappers}
        for kname, n in want.items():
            check(per_batch[kname] == n, f"fp32 {name}: {per_batch}")
        timed = _timed_decodes({"plain": plain, "dispatch": dispatch},
                               {"plain": batch, "dispatch": batch}, p)
        agree = float((tokens == plain(p, *batch).cpu()).float().mean())
        check(agree >= 0.5, f"fp32 {name}: dispatch tokens agree with the "
                            f"plain decode on {agree} < 0.5")
        paths[name] = {"launches_per_batch": per_batch,
                       "captions_per_s": timed["dispatch"]["captions_per_s"],
                       "runs": timed["dispatch"]["runs"],
                       "plain_cells": timed["plain"],
                       "token_agreement_dispatch_vs_plain": agree}
    _reset(wrappers)
    result = {"phase": "fp32", "ok": True, "card": card, "atol": F32_ATOL,
              "tf32": False, "kernels": kernels, "paths": paths}
    emit(result)
    return result


def _k10_kernels(ed, k) -> dict:
    """Each head kernel and the whole step at k (the k <= 16 instances)
    against its plain version at paper shape (N = 2560), with kernel,
    device, plain, library and bound times."""
    import dataclasses

    import torch

    from captionkit_torch.kernels import head as thead
    from captionkit_torch.kernels import megastep as ms
    from captionkit_torch.kernels import wholestep as ws
    from captionkit_torch.models import get_model

    N, H, V = N_IMAGES * BEAM, 1024, 9490
    h, w, b = _head_inputs(N, H, V, 7)
    h8, w_q, scale, b_q, w_qt = _int8_inputs(N, H, V, 7)

    def library():
        logits = torch.matmul(h, w).float() + b
        return torch.topk(logits, k).values, torch.logsumexp(logits, 1)

    cases = {
        "fused_head_topk": (lambda: thead.fused_head_topk(h, w, b, k=k),
                            lambda: thead.reference_head_topk(h, w, b, k),
                            head_agreement, library, False),
        "fused_head_topk_thresh": (
            lambda: thead.fused_head_topk_thresh(h, w, b, k=k),
            lambda: thead.reference_head_topk(h, w, b, k), head_agreement,
            library, False),
        "head_sweep_topk": (lambda: thead.head_sweep_topk(h, w, b, k=k),
                            lambda: thead.reference_head_topk(h, w, b, k),
                            head_agreement, library, False),
        "fused_head_topk_int8": (
            lambda: thead.fused_head_topk_int8(h8, w_q, scale, b_q, k=k,
                                               w_qt=w_qt),
            lambda: thead.reference_head_topk_int8(h8, w_q, scale, b_q, k),
            int8_agreement, None, True),
    }
    out = {}
    for name, (run, plain, agree, lib, int8) in cases.items():
        res = _hold(f"{name} k={k}", run, plain, agree)
        ms_ = time_ms(run, iters=10)
        bound = _head_bound(N, H, V, k, int8=int8)
        out[name] = {**res, "ms": ms_,
                     "device_ms": _device_ms(run, ("head_",)),
                     "plain_ms": time_ms(plain, iters=3),
                     "library_ms": time_ms(lib, iters=10) if lib else None,
                     **bound, "bound_share": bound["bound_ms"] / ms_}
    cfg, _, params, _ = ed
    mc = dataclasses.replace(cfg.model, cell_impl="wholestep")
    with torch.inference_mode():
        ctx_k = _encoded(get_model(mc), params, mc)
    pack = ctx_k.cell_pack
    g = torch.Generator().manual_seed(11)
    h_att, c_att, h_lang, c_lang = (
        (torch.randn((N, mc.hidden_dim), generator=g) * 0.5).cuda()
        for _ in range(4))
    emb = (torch.randn((N, mc.emb_dim), generator=g) * 0.1).cuda()
    with torch.inference_mode():
        h2, _, vhat_raw, c_star = ms.att_phase(pack, h_att, c_att, h_lang,
                                               emb)
    args = (pack, vhat_raw, h2, c_star, h_lang, c_lang, ctx_k.head_w,
            ctx_k.head_b)
    run = lambda: ws.fused_lang_head_topk(*args, k=k)  # noqa: E731
    res = _hold(f"fused_lang_head_topk k={k}", run,
                lambda: ws.reference_lang_head_topk(*args, k=k),
                wholestep_agreement)
    ms_ = time_ms(run, iters=10)
    bound = _wholestep_bound(N, mc.hidden_dim, mc.feat_dim, mc.vocab_size, k)
    out["fused_lang_head_topk"] = {
        **res, "ms": ms_,
        "device_ms": _device_ms(run, ("lang_head_kernel",)),
        "plain_ms": time_ms(lambda: ws.reference_lang_head_topk(*args, k=k),
                            iters=3), "library_ms": None, **bound,
        "bound_share": bound["bound_ms"] / ms_}
    return out


def phase_beam10(ed, wrappers, card) -> dict:
    """decode.beam_size = 10 (k = 10, above the first kernels' largest 8)
    on editnet_beam5 at batch 512: the default path's decode through the
    head kernel (22 launches a batch, captions/s), the head kernel against
    its plain version on the decode's own states; the whole-step path at
    k = 10 (decode beside the pallas cells, 22 launches a batch, its steps
    check); and each head kernel and the whole step at k = 10 at paper
    shape, timed."""
    from captionkit_torch.kernels.head import fused_head_topk
    from captionkit_torch.models import get_model

    cfg, _, params, vocab = ed
    beam = 10
    cfg10 = cfg.override({"decode.beam_size": beam})
    model = get_model(cfg10.model)
    kw = dict(start_id=vocab.start, end_id=-1, pad_id=vocab.pad,
              device="cuda")
    launches, tokens = _count_decode(cfg10, model, params, vocab, wrappers)
    check(launches["fused_head_topk"] == MAX_LEN,
          f"beam 10 decode: {launches}")
    from captionkit_torch.decode import make_decode_fn

    batch = _batch(cfg10.model)
    decode = make_decode_fn(model, cfg10.decode, **kw)
    timed = _timed_decodes({"beam10": decode}, {"beam10": batch}, params)
    steps = _check_steps(model, params, [t.cuda() for t in batch], kw,
                         beam=beam)
    cfg_w = cfg10.override({"model.cell_impl": "wholestep"})
    model_w = get_model(cfg_w.model)
    out_w, _, _, ctx_k, hyps = _decode_pair(
        cfg_w, model_w, params, vocab, wrappers,
        ("att_cell", "fused_lang_head_topk"), other="pallas", beam=beam)
    steps_w = _check_wholestep_steps(model_w, cfg_w.model, params, ctx_k,
                                     hyps, vocab.start, beam=beam)
    result = {"phase": "beam10", "ok": True, "card": card, "beam": beam,
              "batch": N_IMAGES, "steps": MAX_LEN,
              "launches_per_batch": launches,
              "head_launches": fused_head_topk.launches,
              "captions_per_s": timed["beam10"]["captions_per_s"],
              "runs": timed["beam10"]["runs"], "steps_check": steps,
              "wholestep": {**out_w, "steps_check": steps_w},
              "kernels": _k10_kernels(ed, beam)}
    emit(result)
    return result


def _wide_tie_patterns(H):
    """(name, h, w, b, k) of the tiled float heads at a wide H (h streamed):
    h one-hot in its last 16 columns (row i selects pattern row i mod 16),
    the integer patterns of ``_tiled_tie_patterns`` in W's last 16 rows and
    random integers in W's other rows (met by h's zeros, so every logit is
    exact in bf16): ties on both sides of every cluster share boundary of
    the wide plan, in every tile and across whole rows; 2560 rows, V =
    9600, k = 1, 5, 16."""
    import numpy as np
    import torch

    from captionkit_torch.kernels import head as thead
    from captionkit_torch.kernels.head import TILE_V

    N, V, P = N_IMAGES * BEAM, 9600, 16
    shares, per = thead.sweep_plan(N, V, thead.cluster_table(
        "head_topk", torch.device("cuda"), wide=True))
    cuts = [c * per * TILE_V for c in range(1, shares)
            if c * per * TILE_V < V]
    check(len(cuts) >= 1, f"wide plan {shares, per} has no boundary")
    rng = np.random.default_rng(N + H)
    pat = rng.integers(-2, 2, (P, V)).astype(np.float32)
    pat[0] = 1.0
    for cut in cuts:
        pat[1, [cut - 1, cut]] = 5.0
        pat[2, [cut - 2, cut + 1]] = 6.0
        pat[3, [cut - 1, cut, 0, V - 1]] = 3.0
        pat[5, cut - 4:cut + 4] = 4.0
    for c in range(shares):
        pat[4, min(c * per * TILE_V + 5, V - 1)] = 7.0
    for t in range(V // TILE_V):
        pat[6, t * TILE_V + 3] = 9.0
        pat[7, t * TILE_V + 126:t * TILE_V + 130] = 2.0
    w = rng.integers(-3, 3, (H, V)).astype(np.float32)
    w[H - P:] = pat
    h = np.zeros((N, H), np.float32)
    h[np.arange(N), H - P + np.arange(N) % P] = 1.0
    args = (torch.from_numpy(h).to("cuda", torch.bfloat16),
            torch.from_numpy(w).to("cuda", torch.bfloat16),
            torch.zeros((V,), device="cuda"))
    return [(f"{shares}_shares_k{k}", *args, k) for k in (1, 5, 16)]


def _wide_tiled(H, hb, w_p, b_p, skipped, k) -> dict:
    """The tiled bf16 heads, mask and thresh, at a wide H (h streamed
    beside W): each within the head bar against its plain version with
    h's second 64-wide chunk zeroed (a planted fault) failing it; thresh
    bit-equal to mask; exact on the wide plan's share, tile and row ties,
    where a merge that breaks ties to the higher id, a share left out and
    a tile skipped on an equal max must fail; kernel, device, plain,
    library and bound times."""
    import torch

    from captionkit_torch.kernels import head as thead

    N, V = hb.shape[0], 9490
    out = {}
    plain = lambda: thead.reference_head_topk(hb, w_p, b_p, k)  # noqa: E731
    mask = thead.fused_head_topk(hb, w_p, b_p, k=k)
    wb = w_p[:, :V]

    def library():
        logits = torch.matmul(hb, wb).float() + b_p[:V]
        return torch.topk(logits, k).values, torch.logsumexp(logits, 1)

    plain_ms = time_ms(plain, iters=5)
    library_ms = time_ms(library, iters=10)
    ties = _wide_tie_patterns(H)
    for name, fn in (("fused_head_topk", thead.fused_head_topk),
                     ("fused_head_topk_thresh",
                      thead.fused_head_topk_thresh)):
        run = lambda fn=fn: fn(hb, w_p, b_p, k=k)  # noqa: E731
        res = _hold(f"{name} H={H}", run, plain, head_agreement,
                    [("second_h_chunk_skipped",
                      lambda fn=fn: fn(skipped, w_p, b_p, k=k))])
        if fn is thead.fused_head_topk_thresh:
            check(bit_agreement(run(), mask)["ok"],
                  f"thresh differs from mask at H={H}")
        kernel = "mask" if fn is thead.fused_head_topk else "thresh"
        res["share_ties"], caught = {}, {}
        for case, th, tw, tb, tk in ties:
            got, want = fn(th, tw, tb, k=tk), \
                thead.reference_head_topk(th, tw, tb, tk)
            lse_err = float((got[2] - want[2]).abs().max())
            exact = bool(torch.equal(got[0], want[0])
                         and torch.equal(got[1], want[1]))
            if kernel == "thresh":
                exact = exact and bit_agreement(
                    got, thead.fused_head_topk(th, tw, tb, k=tk))["ok"]
            res["share_ties"][case] = {"exact": exact, "lse_err": lse_err}
            check(exact and lse_err <= 1e-5,
                  f"{name} H={H} ties {case}: lse err {lse_err}")
            for fault, bad in _tiled_faults(kernel, th, tw, tb, tk):
                v, i, l = bad()
                caught[fault] = caught.get(fault, False) or not (
                    torch.equal(v, want[0]) and torch.equal(i, want[1]))
        check(all(caught.values()),
              f"{name} H={H}: planted faults on the ties: {caught}")
        res["tie_faults_caught"] = caught
        ms_ = time_ms(run, iters=10)
        bound = _head_bound(N, H, V, k, int8=False)
        launches, dev_ms = _profile_calls(run, ("head_",))
        out[f"{name}/H={H}"] = {
            **res, "ms": ms_, "device_ms": dev_ms,
            "cuda_launches_per_call": round(launches),
            "plain_ms": plain_ms, "library_ms": library_ms, **bound,
            "bound_share": bound["bound_ms"] / ms_}
    return out


def phase_wide_head(card) -> dict:
    """The single sweep (h streamed beside W above H = 1024), the tiled
    bf16 heads mask and thresh (h streamed; ``_wide_tiled``) and the int8
    head (its quantized rows streamed beside w_qt) at H = 2048 and 4096,
    N = 2560, V = 9490, k = 5: within their bars against their plain
    versions; a float head that skips h's second 64-wide chunk (a planted
    fault) must fail; the tiled heads exact on the wide plan's ties;
    kernel, plain, library and bound times."""
    import torch

    from captionkit_torch.kernels import head as thead

    N, V, k = N_IMAGES * BEAM, 9490, BEAM
    out = {}
    for H in (2048, 4096):
        g = torch.Generator().manual_seed(H)
        h = torch.randn((N, H), generator=g).cuda()
        w = (torch.randn((H, V), generator=g) * H ** -0.5).cuda()
        b = (torch.randn((V,), generator=g) * 0.01).cuda()
        hb = h.bfloat16()
        w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.bfloat16)
        skipped = hb.clone()
        skipped[:, 64:128] = 0
        sweep = _hold(f"head_sweep_topk H={H}",
                      lambda: thead.head_sweep_topk(hb, w_p, b_p, k=k),
                      lambda: thead.reference_head_topk(hb, w_p, b_p, k),
                      head_agreement,
                      [("second_h_chunk_skipped",
                        lambda: thead.head_sweep_topk(skipped, w_p, b_p,
                                                      k=k))])
        wb = w.bfloat16()

        def library():
            logits = torch.matmul(hb, wb).float() + b
            return torch.topk(logits, k).values, torch.logsumexp(logits, 1)

        out.update(_wide_tiled(H, hb, w_p, b_p, skipped, k))
        run = lambda: thead.head_sweep_topk(hb, w_p, b_p, k=k)  # noqa: E731
        ms_ = time_ms(run, iters=10)
        bound = _head_bound(N, H, V, k, int8=False)
        out[f"head_sweep_topk/H={H}"] = {
            **sweep, "ms": ms_, "device_ms": _device_ms(run, ("head_",)),
            "plain_ms": time_ms(lambda: thead.reference_head_topk(
                hb, w_p, b_p, k), iters=5),
            "library_ms": time_ms(library, iters=10), **bound,
            "bound_share": bound["bound_ms"] / ms_}
        w_q, scale, b_q = thead.quantize_head(w, b)
        w_qt = thead.kmajor_head(w_q)
        run8 = lambda: thead.fused_head_topk_int8(  # noqa: E731
            h, w_q, scale, b_q, k=k, w_qt=w_qt)
        int8 = _hold(f"fused_head_topk_int8 H={H}", run8,
                     lambda: thead.reference_head_topk_int8(h, w_q, scale,
                                                            b_q, k),
                     int8_agreement)
        ms8 = time_ms(run8, iters=10)
        bound8 = _head_bound(N, H, V, k, int8=True)
        out[f"fused_head_topk_int8/H={H}"] = {
            **int8, "ms": ms8, "device_ms": _device_ms(run8, ("head_",)),
            "plain_ms": time_ms(lambda: thead.reference_head_topk_int8(
                h, w_q, scale, b_q, k), iters=3), "library_ms": None,
            **bound8, "bound_share": bound8["bound_ms"] / ms8}
    result = {"phase": "wide_head", "ok": True, "card": card, "N": N,
              "V": V, "k": k, "kernels": out}
    emit(result)
    return result



N_TEST, REFS_A_IMAGE = 5000, 5  # the Karpathy test split


def _write_karpathy(root: Path, V: int, *, n_test: int = N_TEST,
                    train_features: bool = False, n_val: int = 0) -> dict:
    """A synthetic split in the Karpathy layout, from seed 0: train
    captions whose words give ``prepare`` a wordmap of exactly V entries
    (V - 4 words, each 5 times, the default min_word_freq; 949 images of 5
    ten-word captions at V = 9490), ``n_test`` test images with 5
    references each (5 to 16 words of the train vocab, Zipf-distributed),
    an existing-caption JSON per split (the test split's: a reference with
    a word dropped), and the test features [n_test, 36, 2048] float32 as
    .npy. ``train_features`` adds the train images' features, ``n_val`` a
    val split drawn as the test split is, with its features (both drawn
    after everything else, so the test split is the same either way)."""
    import numpy as np

    rng = np.random.default_rng(0)
    words = [f"w{i:04d}" for i in range(V - 4)]
    stream = np.repeat(np.arange(len(words)), 5)
    rng.shuffle(stream)
    sents = [[words[j] for j in stream[i:i + 10]]
             for i in range(0, len(stream), 10)]
    images, existing = [], {"train": []}
    cocoid = 100000
    for lo in range(0, len(sents), REFS_A_IMAGE):
        caps = sents[lo:lo + REFS_A_IMAGE]
        images.append({"split": "train", "cocoid": cocoid,
                       "sentences": [{"tokens": c} for c in caps]})
        existing["train"].append({"image_id": cocoid,
                                  "caption": " ".join(caps[0])})
        cocoid += 1
    n_train = len(existing["train"])

    def held_out(split, n):
        nonlocal cocoid
        ids = []
        existing[split] = []
        for _ in range(n):
            caps = [[words[min(int(j), len(words)) - 1]
                     for j in rng.zipf(1.3, int(rng.integers(5, 17)))]
                    for _ in range(REFS_A_IMAGE)]
            images.append({"split": split, "cocoid": cocoid,
                           "sentences": [{"tokens": c} for c in caps]})
            existing[split].append({"image_id": cocoid,
                                    "caption": " ".join(caps[0][1:])})
            ids.append(cocoid)
            cocoid += 3
        return ids

    test_ids = held_out("test", n_test) if n_test else []
    root.mkdir(parents=True, exist_ok=True)
    paths = {"karpathy": root / "dataset_coco.json"}

    def features(name, n):
        paths[name] = root / f"{name}.npy"
        feats = np.lib.format.open_memmap(
            paths[name], mode="w+", dtype=np.float32, shape=(n, 36, 2048))
        for lo in range(0, n, 500):
            feats[lo:lo + 500] = rng.standard_normal(
                (min(500, n - lo), 36, 2048), dtype=np.float32)
        feats.flush()

    if n_test:
        features("features", n_test)
    val_ids = held_out("val", n_val) if n_val else []
    if train_features:
        features("features_train", n_train)
    if n_val:
        features("features_val", n_val)
    paths["karpathy"].write_text(json.dumps({"images": images}))
    for split, rows in existing.items():
        paths[f"existing_{split}"] = root / f"existing_{split}.json"
        paths[f"existing_{split}"].write_text(json.dumps(rows))
    return {"paths": paths, "test_ids": test_ids, "val_ids": val_ids,
            "n_train": n_train}


def _cli(*argv, timeout=900) -> dict:
    """``python -m captionkit_torch.cli ARGV`` in a process of its own;
    its printed JSON."""
    proc = subprocess.run(
        [sys.executable, "-m", "captionkit_torch.cli", *map(str, argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0,
          f"cli {argv[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout)


def phase_evaluate(ed, wrappers, card) -> dict:
    """Decode and score a split at full width: a synthetic Karpathy split
    (5,000 test images, 5 references each) through ``cli prepare`` and
    ``cli decode --prepared`` (editnet_beam5, batch 512, the end id
    enabled, the weights of the serve phase) in processes of their own;
    the same artifacts through the raw reference-file flags in this
    process (launches counted): identical captions and metrics; the
    native CIDEr-D against the Python CiderD on the decoded hypotheses;
    the native FeatureStore gather against numpy's; the backpointer beam
    against the register beam on one batch."""
    import shutil

    import numpy as np
    import torch

    from captionkit_torch import cli
    from captionkit_torch.data.prepare import load_prepared_split
    from captionkit_torch.data.tokenize import ptb_tokenize
    from captionkit_torch.decode.beam import beam_search
    from captionkit_torch.kernels.head import fused_head_topk
    from captionkit_torch.metrics.cider import CiderD, NgramDocFreq
    from captionkit_torch.metrics.eval import CaptionEvaluator
    from captionkit_torch.metrics.fast import NativeCiderD

    cfg, model, params, _ = ed
    root = SMOKE_DIR / "evaluate"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        made = _write_karpathy(root, cfg.model.vocab_size)
        paths, test_ids = made["paths"], made["test_ids"]
        write_s = time.perf_counter() - t0
        prep = root / "prepared"
        t0 = time.perf_counter()
        _cli("prepare", "--karpathy", paths["karpathy"], "--out", prep,
             "--existing", f"train={paths['existing_train']}",
             "--existing", f"test={paths['existing_test']}",
             "--features", f"test={paths['features']}")
        prepare_s = time.perf_counter() - t0
        paths["features"].unlink()
        wordmap = json.loads((prep / "WORDMAP.json").read_text())
        check(len(wordmap) == cfg.model.vocab_size,
              f"prepare made a wordmap of {len(wordmap)} entries")
        npz = SMOKE_DIR / "params_editnet.npz"
        common = ["--config", "editnet_beam5", "--params", npz,
                  "--set", f"decode.batch_size={N_IMAGES}"]
        t0 = time.perf_counter()
        metrics = _cli("decode", *common, "--prepared", prep, "--split",
                       "test", "--out", root / "results.json")
        decode_cli_s = time.perf_counter() - t0
        results = json.loads((root / "results.json").read_text())
        check(len(results) == N_TEST,
              f"{len(results)} results for {N_TEST} images")
        check([r["image_id"] for r in results] == test_ids,
              "results are not keyed by the split's cocoids")
        keys = [f"BLEU-{n}" for n in range(1, 5)] + ["ROUGE-L", "CIDEr"]
        check(all(k in metrics for k in keys), f"metrics {sorted(metrics)}")
        check(metrics["captions"] == N_TEST and
              metrics["captions_per_sec"] > 0, f"stats {metrics}")

        # The raw reference-file route, in this process, counted.
        raw_out = io.StringIO()
        for w in wrappers:
            w.launches = 0
        with contextlib.redirect_stdout(raw_out):
            rc = cli.main([str(a) for a in (
                "decode", *common, "--wordmap", prep / "WORDMAP.json",
                "--captions", prep / "TEST_CAPTIONS.json",
                "--caplens", prep / "TEST_CAPLENS.json",
                "--existing", prep / "TEST_EXISTING.json",
                "--existing-lens", prep / "TEST_EXISTING_CAPLENS.json",
                "--features", prep / "TEST_FEATURES.npy",
                "--out", root / "raw.json", "--device", "cuda")])
        launches = {w.__name__: w.launches for w in wrappers}
        check(rc == 0, f"raw-file decode returned {rc}")
        check(launches["fused_head_topk"] > 0,
              f"the decode launched no head kernel: {launches}")
        raw_metrics = json.loads(raw_out.getvalue())
        raw = json.loads((root / "raw.json").read_text())
        hyps = [r["caption"] for r in results]
        check([r["caption"] for r in raw] == hyps,
              "the raw-file route decoded other captions: "
              f"{sum(a['caption'] != b for a, b in zip(raw, hyps))} differ")
        check(all(raw_metrics[k] == metrics[k] for k in keys),
              f"raw-file metrics {raw_metrics} against {metrics}")

        # Scoring: the Python metrics, and CIDEr-D native against Python.
        ds = load_prepared_split(str(prep), "test")
        refs = {i: [" ".join(t) for t in ds.references[i]]
                for i in range(N_TEST)}
        hyp_by_img = dict(enumerate(hyps))
        t0 = time.perf_counter()
        scored = CaptionEvaluator().evaluate(refs, hyp_by_img)
        score_s = time.perf_counter() - t0
        check(all(round(scored[k], 4) == metrics[k] for k in keys),
              f"scores {scored} against the decode's {metrics}")
        hyp_tok = [ptb_tokenize(h) for h in hyps]
        ref_tok = [[ptb_tokenize(r) for r in refs[i]] for i in range(N_TEST)]
        df = NgramDocFreq.build(ref_tok)
        t0 = time.perf_counter()
        _, py_cider = CiderD(df).compute(hyp_tok, ref_tok)
        py_cider_s = time.perf_counter() - t0
        native = NativeCiderD(df)
        t0 = time.perf_counter()
        nat_cider = native.score(hyp_tok, ref_tok)
        native_cider_s = time.perf_counter() - t0
        cider_err = float(np.abs(nat_cider - py_cider).max())
        check(cider_err <= 1e-9,
              f"native CIDEr-D off the Python CiderD by {cider_err}")
        check(abs(float(py_cider.mean()) - scored["CIDEr"]) <= 1e-12,
              "CiderD with the split's df is not the evaluator's CIDEr")

        # The feature store: native, and byte-equal to numpy on a batch.
        from captionkit_torch.data.faststore import FeatureStore

        store = ds.features
        check(store.is_native, "FeatureStore did not take the native path")
        plain = FeatureStore(store.path, native=False)
        rows = np.random.default_rng(1).permutation(N_TEST)[:N_IMAGES]
        check(store.gather(rows).tobytes() == plain.gather(rows).tobytes(),
              "native gather differs from numpy's")
        gather_ms = {}
        for name, s in (("native", store), ("numpy", plain)):
            runs = []
            for i in range(5):
                sel = np.sort(rows) if i % 2 else rows
                t0 = time.perf_counter()
                s.gather(sel)
                runs.append(1e3 * (time.perf_counter() - t0))
            gather_ms[name] = statistics.median(runs)

        # backptr against register on the first batch: with the split's
        # end id, and with the token the register decode emits most often
        # taken as the end id, so that hypotheses finish at many steps.
        batch = next(ds.eval_view().batches(N_IMAGES))
        beams = {}
        with torch.inference_mode():
            ctx = model.encode(
                params, torch.from_numpy(batch.features).cuda(),
                torch.from_numpy(batch.existing).long().cuda(),
                torch.from_numpy(batch.existing_len).long().cuda())
            kw = dict(beam_size=cfg.decode.beam_size,
                      start_id=ds.vocab.start, pad_id=ds.vocab.pad,
                      max_len=MAX_LEN)
            end_id = ds.vocab.end
            for end_name in ("split_end_id", "frequent_token"):
                if end_name == "frequent_token":
                    counts = torch.bincount(
                        out["register"].all_tokens.flatten().long())
                    counts[ds.vocab.pad] = 0
                    end_id = int(counts.argmax())
                out, ms = {}, {}
                for impl in ("register", "backptr"):
                    for w in wrappers:
                        w.launches = 0
                    out[impl] = beam_search(model, params, ctx, impl=impl,
                                            end_id=end_id, **kw)
                    check(fused_head_topk.launches > 0,
                          f"{impl} beam launched no head kernel")
                    ms[impl] = time_ms(
                        lambda: beam_search(model, params, ctx, impl=impl,
                                            end_id=end_id, **kw),
                        iters=3, warm=1)
                for f in out["register"]._fields:
                    check(torch.equal(getattr(out["backptr"], f),
                                      getattr(out["register"], f)),
                          f"backptr {f} differs from register's "
                          f"({end_name})")
                done = (out["backptr"].all_tokens == end_id).any(dim=2)
                beams[end_name] = {
                    "end_id": end_id, "ms_a_batch": ms,
                    "finished_hypotheses": int(done.sum()),
                    "finish_steps": len(set(out["backptr"].all_lengths[done]
                                            .tolist()))}
        check(beams["frequent_token"]["finish_steps"] > 1,
              f"hypotheses finished at too few steps: {beams}")
        result = {
            "phase": "evaluate", "ok": True, "card": card,
            "images": N_TEST, "refs_a_image": REFS_A_IMAGE,
            "batch": N_IMAGES, "config": "editnet_beam5",
            "write_split_s": write_s, "prepare_s": prepare_s,
            "decode_cli_s": decode_cli_s,
            "decode_wall_s": metrics["wall_s"],
            "captions_per_s": metrics["captions_per_sec"],
            "raw_route": {"decode_wall_s": raw_metrics["wall_s"],
                          "captions_per_s": raw_metrics["captions_per_sec"],
                          "launches": launches},
            "metrics": {k: metrics[k] for k in keys},
            "empty_hypotheses": sum(not h for h in hyps),
            "scoring_s": score_s, "python_cider_d_s": py_cider_s,
            "native_cider_d_s": native_cider_s,
            "native_cider_d_max_err": cider_err,
            "gather_ms_a_batch": gather_ms,
            "beams": beams,
            "nvidia_smi": card}
        emit(result)
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# Cross-entropy training (train/): xe_train at paper width
# --------------------------------------------------------------------------

N_VAL = 512  # validation images, 5 references each
TRAIN_DEVICE = "cuda"
TRAIN_BATCH = 256  # DataConfig.batch_size of xe_train
# The deferred backward against autograd through the loop, per weight:
# max |deferred - autograd| / max |autograd|. The two routes round
# differently in bf16 (the deferred one rounds every step's product
# cotangent to bf16 for its single weight-gradient product, as the
# reference's does; autograd rounds each step's weight gradient), so they
# differ by a few bf16 ulps of the larger gradients: GRAD_RTOL. The
# attentions' query kernels and biases get a gradient that is the
# remainder of a sum over positions which cancels to first order (a
# softmax backward sums to zero) and sits at the rounding floor of its
# terms: GRAD_RTOL_FLOOR (a dropped or wrong term moves a gradient by its
# whole size, 1.0).
GRAD_RTOL = 5e-2
GRAD_RTOL_FLOOR = 0.5
GRAD_FLOOR = ("vis_attention/w_q", "vis_attention/b", "scma/w_q", "scma/b")


def _train_bound(P, B, T, Tm, E, H, A, F, R, V) -> dict:
    """The least time of an XE step (``xe_train``, EditNet): every product
    of the forward once and of the backward twice (the input's and the
    weight's gradient; the region features need none), bf16 on the tensor
    cores; the attention tanh on the special-function unit; the step's
    inputs read once and its outputs written once in bytes: the batch's
    features, and the P fp32 weights with Adam's two moments read and
    written."""
    step = (2 * B * 2 * H * 4 * H + 2 * 2 * B * H * A + 2 * B * H * F
            + 2 * B * (F + 2 * H) * 4 * H + 2 * B * (F + 3 * H) * H
            + 2 * B * R * F + 2 * B * Tm * H)
    fwd = (2 * B * Tm * E * 4 * H + 2 * B * Tm * H * 4 * H
           + 2 * B * R * F * A + 2 * B * Tm * H * A + 2 * B * F * 4 * H
           + 2 * B * T * E * 4 * H + T * step + 2 * B * T * H * V)
    mm = 3 * fwd - 2 * B * R * F * A
    tanh = B * T * (R + Tm) * A
    ew = 3 * B * T * (R + Tm) * A  # the score terms, forward
    n_bytes = 4 * B * R * F + 8 * B * (2 * Tm + 2) + 6 * 4 * P
    return _ops_bound(mm, ew, n_bytes, tanh=tanh)


def _grad_errors(got: dict, want: dict) -> dict:
    """Per weight: max |got - want| / max |want|."""
    return {n: float((got[n] - want[n]).abs().max()
                     / want[n].abs().max().clamp_min(1e-30)) for n in want}


def _grads(model, params, batch):
    import torch

    from captionkit_torch.params import named_tensors
    from captionkit_torch.train.xe import BATCH_KEYS, xe_loss

    loss, _ = xe_loss(model, params, *(batch[k] for k in BATCH_KEYS),
                      train=True)
    named = named_tensors(params)
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def _grad_check_fails(errors: dict) -> list:
    return [n for n, e in errors.items()
            if e > (GRAD_RTOL_FLOOR if n in GRAD_FLOOR else GRAD_RTOL)]


def _train_steps_timed(fn, state, batches) -> dict:
    """Run ``fn`` over ``batches`` with CUDA events around every step;
    ms a step over the steps after the first, tokens/s over the same
    steps, the first and last loss, the peak memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, metrics = [], []
    for b in batches:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        state, m = fn(state, b)
        e.record()
        events.append((s, e))
        metrics.append(m)
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(m["loss"]) for m in metrics]
    tokens = [int(m["tokens"]) for m in metrics]
    return {"state": state, "ms_first": ms[0],
            "ms_a_step": statistics.mean(ms[1:]),
            "ms_steps": ms,
            "tokens_per_s": 1e3 * sum(tokens[1:]) / sum(ms[1:]),
            "tokens_a_step": statistics.mean(tokens),
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _device_batches(ds, cfg, n, dev, epoch=0):
    from captionkit_torch.train.xe import batch_to_device_dict

    out = []
    for i, b in enumerate(ds.batches(cfg.data.batch_size, shuffle=True,
                                     seed=cfg.train.seed + epoch)):
        if i == n:
            break
        out.append(batch_to_device_dict(b, dev))
    return out


def _cli_in_process(argv) -> dict:
    from captionkit_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return json.loads(out.getvalue())


def profile_train(prep: str) -> None:
    """``chip_smoke.py --profile-train PREP``: two xe_train steps under
    torch.profiler, in a process of its own (the profiler records every
    kernel only in a process's first session); prints one JSON line."""
    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.data.prepare import load_prepared_split
    from captionkit_torch.models import get_model
    from captionkit_torch.train.state import create_train_state
    from captionkit_torch.train.xe import make_xe_train_step

    dev = torch.device(TRAIN_DEVICE)
    cfg = get_named_config("xe_train")
    ds = load_prepared_split(prep, "train", max_len=cfg.data.max_len)
    cfg = cfg.override({"model.vocab_size": len(ds.vocab)})
    model = get_model(cfg.model)
    state = create_train_state(lambda seed: model.init(seed, dev),
                               cfg.train)
    fn = make_xe_train_step(model, cfg.train)
    batches = _device_batches(ds, cfg, 4, dev)
    for b in batches[:2]:
        state, _ = fn(state, b)
    torch.cuda.synchronize()
    holder = {"state": state}

    def run():
        for b in batches[2:]:
            holder["state"], m = fn(holder["state"], b)
        torch.cuda.synchronize()

    prof = _profile(run, top=12)
    prof["steps"] = len(batches) - 2
    print(json.dumps(prof), flush=True)


def mm_dtype_derivative() -> str:
    """Whether ``torch.mm(bf16, bf16, out_dtype=float32)`` has a derivative
    of its own here: "present", or the error its backward raises
    (``nn.cells._MatmulF32Out`` gives the port's route one either way)."""
    import torch

    a = torch.randn(8, 16, device=TRAIN_DEVICE, requires_grad=True)
    b = torch.randn(16, 4, device=TRAIN_DEVICE, requires_grad=True)
    try:
        torch.mm(a.bfloat16(), b.bfloat16(),
                 out_dtype=torch.float32).sum().backward()
    except (RuntimeError, NotImplementedError) as e:
        return f"absent: {type(e).__name__}: {str(e)[:200]}"
    return "present"


def _prefetch_checks(model, cfg, ds, dev, deterministic) -> dict:
    """The loops' prefetched feed (``data/prefetch.py``) against the
    synchronous pageable copy (``batch_to_device_dict``) at xe_train's
    batch: the batches byte-equal; two XE steps from one init with each
    feed give bit-equal losses and parameters (when the step is
    deterministic); ms a step with each feed, in turns (host clock to a
    synchronize, the feed's host work included); the features' copy by
    CUDA events, pinned against pageable."""
    import torch

    from captionkit_torch.data.prefetch import prefetch_to_device
    from captionkit_torch.params import named_tensors
    from captionkit_torch.train.loop import _host_dict
    from captionkit_torch.train.state import create_train_state
    from captionkit_torch.train.xe import (
        batch_host_tensors,
        batch_to_device_dict,
        make_xe_train_step,
    )

    host = []
    for b in ds.batches(cfg.data.batch_size, shuffle=True,
                        seed=cfg.train.seed):
        host.append(_host_dict(b))
        if len(host) == 14:
            break

    def prefetched(hbs):
        return prefetch_to_device((batch_host_tensors(h) for h in hbs),
                                  device=dev)

    def synchronous(hbs):
        return (batch_to_device_dict(h, dev) for h in hbs)

    for got, h in zip(prefetched(host[:4]), host[:4]):
        want = batch_to_device_dict(h, dev)
        check(got.keys() == want.keys(), "prefetched keys")
        for k in want:
            check(got[k].dtype == want[k].dtype
                  and torch.equal(got[k], want[k]),
                  f"prefetched {k} differs from the synchronous copy")

    fn = make_xe_train_step(model, cfg.train)
    runs = {}
    for name, feed in (("synchronous", synchronous),
                       ("prefetch", prefetched)):
        st = create_train_state(lambda seed: model.init(seed, dev),
                                cfg.train)
        losses = []
        for b in feed(host[:2]):
            st, m = fn(st, b)
            losses.append(float(m["loss"]))
        runs[name] = (losses, {n: t.detach().clone() for n, t in
                               named_tensors(st.params).items()})
        del st
    (l_s, p_s), (l_p, p_p) = runs["synchronous"], runs["prefetch"]
    param_diff = max(float((p_s[n] - p_p[n]).abs().max()) for n in p_s)
    if deterministic:
        check(l_s == l_p and param_diff == 0.0,
              f"prefetch changed the steps: losses {l_s} against {l_p}, "
              f"params off by {param_diff}")
    del runs, p_s, p_p
    torch.cuda.empty_cache()

    # ms a step with each feed, in turns over the next 12 batches.
    st = create_train_state(lambda seed: model.init(seed, dev), cfg.train)
    st, _ = fn(st, batch_to_device_dict(host[2], dev))
    turns = {"synchronous": [], "prefetch": []}
    order = ("synchronous", "prefetch", "prefetch", "synchronous")
    for i, name in enumerate(order):
        hbs = host[2 + 3 * i:5 + 3 * i]
        feed = synchronous if name == "synchronous" else prefetched
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in feed(hbs):
            st, _ = fn(st, b)
        torch.cuda.synchronize()
        turns[name].append(1e3 * (time.perf_counter() - t0) / len(hbs))
    del st
    torch.cuda.empty_cache()

    # The features' host-to-device copy alone, by CUDA events.
    feats = batch_host_tensors(host[0])["features"]
    pinned = feats.pin_memory()

    def copy_ms(src, n=5):
        src.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            src.to(dev, non_blocking=True)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    copies = {"pageable": [], "pinned": []}
    for name in ("pageable", "pinned", "pinned", "pageable"):
        copies[name].append(copy_ms(feats if name == "pageable"
                                    else pinned))
    return {"byte_equal_batches": 4,
            "two_steps": {"losses_synchronous": l_s,
                          "losses_prefetch": l_p,
                          "max_abs_param_diff": param_diff},
            "step_ms_turns": turns,
            "step_ms": {k: statistics.mean(v) for k, v in turns.items()},
            "features_mb": feats.numel() * 4 / 1e6,
            "copy_ms_turns": copies,
            "copy_ms": {k: statistics.mean(v) for k, v in copies.items()}}


def phase_train(wrappers, card) -> dict:
    """Cross-entropy training at xe_train's paper width (EditNet, V 9490,
    batch 256, targets of 22): a synthetic Karpathy split (949 train
    images x 5 ten-word captions, 36x2048 float32 features; 512 val
    images, 5 references each) through ``cli prepare``; then in this
    process, wrapper launches counted: ``cli train-xe`` for one epoch (19
    steps) with its CIDEr validation on the val split (the beam through
    fused_head_topk); the same epoch as 12 steps, then ``--resume`` for
    the rest, against the uninterrupted run; ``--export-params`` decoded
    by ``cli decode`` in a process of its own; the deferred backward
    against autograd through the loop on one batch (bf16, dropout 0),
    with a planted dropped term that must fail; ms a step by CUDA events,
    tokens/s, peak memory, the deferred and autograd steps in turns; the
    loop's prefetched feed against the synchronous copy (batches
    byte-equal, two steps bit-equal, ms a step with each in turns, the
    pinned copy against the pageable one); a profile in a process of its
    own, and dcnet_xe_train for a few steps."""
    import shutil

    import numpy as np
    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.data.prepare import load_prepared_split
    from captionkit_torch.models import editnet_backward, get_model
    from captionkit_torch.params import load_params_npz, named_tensors
    from captionkit_torch.train.state import create_train_state
    from captionkit_torch.train.xe import make_xe_train_step

    dev = torch.device(TRAIN_DEVICE)
    root = SMOKE_DIR / "train"
    shutil.rmtree(root, ignore_errors=True)
    try:
        base = get_named_config("xe_train")
        V = base.model.vocab_size
        t0 = time.perf_counter()
        made = _write_karpathy(root, V, n_test=0, train_features=True,
                               n_val=N_VAL)
        paths = made["paths"]
        write_s = time.perf_counter() - t0
        prep = root / "prepared"
        t0 = time.perf_counter()
        _cli("prepare", "--karpathy", paths["karpathy"], "--out", prep,
             "--existing", f"train={paths['existing_train']}",
             "--existing", f"val={paths['existing_val']}",
             "--features", f"train={paths['features_train']}",
             "--features", f"val={paths['features_val']}")
        prepare_s = time.perf_counter() - t0
        for k in ("features_train", "features_val"):
            paths[k].unlink()
        ds = load_prepared_split(str(prep), "train",
                                 max_len=base.data.max_len)
        check(len(ds.vocab) == V, f"wordmap of {len(ds.vocab)} entries")
        per_epoch = -(-ds.size // TRAIN_BATCH)
        common = ["train-xe", "--config", "xe_train", "--prepared", prep,
                  "--split", "train", "--device", TRAIN_DEVICE,
                  "--set", "train.epochs=1", "--set",
                  "train.keep_checkpoints=1", "--set", "train.log_every=5"]

        # 1. One epoch with validation: the main path, launches counted.
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        full = _cli_in_process(common + [
            "--val-split", "val", "--set",
            f"train.checkpoint_dir={root / 'ck_full'}",
            "--export-params", root / "full.npz",
            "--run-dir", root / "run"])
        epoch_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        check(full["step"] == per_epoch,
              f"the epoch ran {full['step']} steps, not {per_epoch}")
        check(launches["fused_head_topk"] > 0,
              f"the validation launched no head kernel: {launches}")
        hist = full["history"][0]
        check(np.isfinite(hist["loss"]) and hist["val_cider"] >= 0,
              f"epoch record {hist}")
        log_rows = [json.loads(x) for x in
                    (root / "run" / "metrics.jsonl").read_text()
                    .splitlines()]
        check(any("val/cider" in r for r in log_rows) and
              any("train/tokens_per_sec" in r for r in log_rows),
              f"metrics.jsonl rows {log_rows[:3]}")

        # 2. Determinism of the card's step, then the resumed run.
        cfg = base.override({"model.vocab_size": V})
        model = get_model(cfg.model)
        batches = _device_batches(ds, cfg, per_epoch, dev)
        twice = []
        for _ in range(2):
            st = create_train_state(lambda seed: model.init(seed, dev),
                                    cfg.train)
            fn = make_xe_train_step(model, cfg.train)
            for b in batches[:2]:
                st, _ = fn(st, b)
            twice.append({n: t.detach().clone()
                          for n, t in named_tensors(st.params).items()})
        det_diff = max(float((twice[0][n] - twice[1][n]).abs().max())
                       for n in twice[0])
        deterministic = det_diff == 0.0
        del twice, st
        part = _cli_in_process(common + [
            "--no-val", "--max-steps", "12", "--set",
            f"train.checkpoint_dir={root / 'ck_resume'}"])
        resumed = _cli_in_process(common + [
            "--no-val", "--resume", "--set",
            f"train.checkpoint_dir={root / 'ck_resume'}",
            "--export-params", root / "resumed.npz"])
        check(part["step"] == 12 and resumed["step"] == per_epoch,
              f"resume ran to {part['step']}, {resumed['step']}")
        a = load_params_npz(str(root / "full.npz"), "cpu")
        b = load_params_npz(str(root / "resumed.npz"), "cpu")
        resume_diff = max(float((x - named_tensors(b)[n]).abs().max())
                          for n, x in named_tensors(a).items())
        lr, n_after = cfg.train.learning_rate, per_epoch - 12
        # Bit-equal when the step is deterministic; else Adam moves every
        # weight by at most about lr a step, so two runs whose gradients
        # differ in rounding stay within 2 lr a resumed step.
        resume_tol = 0.0 if deterministic else 2 * lr * n_after
        check(resume_diff <= resume_tol,
              f"resumed params off the uninterrupted run by {resume_diff}")
        loss_full = hist["loss"]
        loss_parts = (12 * part["history"][0]["loss"] + n_after
                      * resumed["history"][0]["loss"]) / per_epoch
        loss_rel = abs(loss_parts - loss_full) / abs(loss_full)
        check(loss_rel <= (1e-6 if deterministic else 1e-3),
              f"resumed losses {loss_parts} against {loss_full}")

        # 3. The exported weights decode through cli decode.
        t0 = time.perf_counter()
        decoded = _cli("decode", "--config", "editnet_beam5", "--prepared",
                       prep, "--split", "val", "--params", root / "full.npz",
                       "--set", f"decode.batch_size={N_IMAGES}",
                       "--device", TRAIN_DEVICE)
        decode_cli_s = time.perf_counter() - t0
        check(decoded["captions"] == N_VAL and "CIDEr" in decoded,
              f"decode of the exported weights: {decoded}")

        # 4. The deferred backward against autograd on one batch.
        nodrop = cfg.override({"model.dropout": 0.0})
        m_def = get_model(nodrop.model)
        m_auto = get_model(nodrop.override(
            {"model.deferred_backward": False}).model)
        st = create_train_state(lambda seed: m_def.init(seed, dev),
                                cfg.train)
        want = _grads(m_auto, st.params, batches[0])
        got = _grads(m_def, st.params, batches[0])
        errors = _grad_errors(got, want)
        failing = _grad_check_fails(errors)
        check(not failing, f"deferred gradients off autograd: "
                           f"{ {n: errors[n] for n in failing} }")
        editnet_backward.PLANTED_FAULT = "lang_wrc"
        try:
            planted = _grad_check_fails(_grad_errors(
                _grads(m_def, st.params, batches[0]), want))
        finally:
            editnet_backward.PLANTED_FAULT = None
        check(planted == ["lang_lstm/wrc"],
              f"the dropped lang_wrc term was not caught: {planted}")
        del want, got, st
        torch.cuda.empty_cache()

        # 5. Times: one epoch from a fresh state (deferred, the default),
        # then the deferred and autograd steps in turns.
        st = create_train_state(lambda seed: model.init(seed, dev),
                                cfg.train)
        timed = _train_steps_timed(make_xe_train_step(model, cfg.train),
                                   st, batches)
        del st, timed["state"]
        torch.cuda.empty_cache()
        m_auto_d = get_model(cfg.override(
            {"model.deferred_backward": False}).model)
        turns = {"deferred": [], "autograd": []}
        peak = {}
        states = {}
        fns = {"deferred": make_xe_train_step(model, cfg.train),
               "autograd": make_xe_train_step(m_auto_d, cfg.train)}
        for name in fns:
            states[name] = create_train_state(
                lambda seed: model.init(seed, dev), cfg.train)
            states[name], _ = fns[name](states[name], batches[0])
        for rnd in range(4):
            for name in (("deferred", "autograd") if rnd % 2 == 0
                         else ("autograd", "deferred")):
                r = _train_steps_timed(fns[name], states[name],
                                       batches[1 + 3 * rnd:4 + 3 * rnd])
                states[name] = r["state"]
                turns[name].append(statistics.mean(r["ms_steps"]))
                peak[name] = max(peak.get(name, 0.0), r["peak_memory_gb"])
        del states
        torch.cuda.empty_cache()

        # 6. The prefetched feed against the synchronous copy.
        prefetch = _prefetch_checks(model, cfg, ds, dev, deterministic)

        # 7. A profile of two steps, in a process of its own.
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--profile-train",
             str(prep)], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        check(proc.returncode == 0,
              f"train profile exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        prof = json.loads(proc.stdout.strip().splitlines()[-1])

        # 8. dcnet_xe_train for a few steps.
        dcfg = get_named_config("dcnet_xe_train").override(
            {"model.vocab_size": V})
        dmodel = get_model(dcfg.model)
        dst = create_train_state(lambda seed: dmodel.init(seed, dev),
                                 dcfg.train)
        dc = _train_steps_timed(make_xe_train_step(dmodel, dcfg.train), dst,
                                batches[:6])
        del dst, dc["state"]
        check(np.isfinite(dc["loss_last"]), f"DCNet loss {dc['loss_last']}")

        P = sum(t.numel() for t in named_tensors(model.init(0, "cpu"))
                .values())
        bound = _train_bound(P, TRAIN_BATCH, base.data.max_len - 1,
                             base.data.max_existing_len, 1024, 1024, 512,
                             2048, 36, V)
        result = {
            "phase": "train", "ok": True, "card": card,
            "config": "xe_train", "batch": TRAIN_BATCH,
            "train_images": made["n_train"], "train_captions": ds.size,
            "val_images": N_VAL, "steps_a_epoch": per_epoch,
            "params": P,
            "write_split_s": write_s, "prepare_s": prepare_s,
            "epoch_cli_s": epoch_s,
            "epoch": {k: hist[k] for k in hist},
            "validation": {"decode_s": hist["val_decode_s"],
                           "score_s": hist["val_score_s"],
                           "cider": hist["val_cider"],
                           "head_launches": launches["fused_head_topk"]},
            "launches": launches,
            "deterministic": deterministic,
            "same_steps_max_abs_diff": det_diff,
            "mm_dtype_derivative": mm_dtype_derivative(),
            "resume": {"max_abs_diff": resume_diff, "tol": resume_tol,
                       "loss_rel_diff": loss_rel},
            "export_decode": {"cli_s": decode_cli_s,
                              "cider": decoded["CIDEr"]},
            "grad_check": {"rtol": GRAD_RTOL,
                           "rtol_floor": GRAD_RTOL_FLOOR,
                           "max_rel_err": max(
                               e for n, e in errors.items()
                               if n not in GRAD_FLOOR),
                           "max_rel_err_floor": max(
                               errors[n] for n in GRAD_FLOOR),
                           "errors": errors,
                           "planted_lang_wrc_caught": True},
            "step": {k: v for k, v in timed.items() if k != "ms_steps"},
            "ms_steps": timed["ms_steps"],
            "turns_ms": turns,
            "turns_mean_ms": {k: statistics.mean(v)
                              for k, v in turns.items()},
            "turns_peak_memory_gb": peak,
            "prefetch": prefetch,
            "profile": prof,
            "bound": bound,
            "dcnet_xe_train": {k: v for k, v in dc.items()
                               if k not in ("state", "ms_steps")},
            "nvidia_smi": card}
        emit(result)
        return result
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


SCST_STEPS = 3  # steps of each timed run, of the cli run and of DCNet's


def _scst_batches(ds, cfg, n, dev, rewarder):
    """The first ``n`` SCST batches of epoch 0 on ``dev`` (the loop's
    shuffle), each with its images' references and their ids from
    ``rewarder.intern`` (the loop interns them once, before its steps)."""
    from captionkit_torch.train.xe import batch_to_device_dict

    out = []
    for i, b in enumerate(ds.batches(cfg.data.batch_size, shuffle=True,
                                     seed=cfg.train.seed + 1000)):
        if i == n:
            break
        refs = [ds.references[int(j)] for j in b.image_id]
        out.append((batch_to_device_dict(b, dev), refs,
                    rewarder.intern(refs)))
    return out


def _scst_setup(prep, xe_npz, name="scst_train", **over):
    """(cfg, model, train split, train state from the XE weights)."""
    from captionkit_torch.config import get_named_config
    from captionkit_torch.data.prepare import load_prepared_split
    from captionkit_torch.models import get_model
    from captionkit_torch.params import load_params_npz
    from captionkit_torch.train.state import create_train_state

    base = get_named_config(name)
    ds = load_prepared_split(str(prep), "train", max_len=base.data.max_len)
    cfg = base.override({"model.vocab_size": len(ds.vocab), **over})
    model = get_model(cfg.model)
    state = create_train_state(
        lambda seed: load_params_npz(str(xe_npz), TRAIN_DEVICE,
                                     arch=model.name), cfg.train)
    return cfg, model, ds, state


def _scst_fns(model, cfg, vocab, n=1):
    from captionkit_torch.train.scst import make_scst_rollout, \
        make_scst_update

    return (make_scst_rollout(model, start_id=vocab.start, end_id=vocab.end,
                              pad_id=vocab.pad,
                              max_len=cfg.decode.max_decode_len,
                              num_samples=n),
            make_scst_update(model, cfg.override(
                {"train.learning_rate": cfg.train.scst_learning_rate}).train,
                start_id=vocab.start, num_samples=n))


def _scst_grads(model, cfg, vocab, state, batch, toks, mask, adv) -> dict:
    """The gradient one SCST update applies, by name: the update function
    itself, its optimizer replaced by one that keeps the gradients and
    changes nothing."""
    from captionkit_torch.train import scst as scst_mod

    kept = {}

    class Keep:
        def update(self, grads, opt_state, params):
            kept.update({n: g.detach().clone() for n, g in grads.items()})

    real = scst_mod.make_optimizer
    scst_mod.make_optimizer = lambda *a, **k: Keep()
    try:
        fn = scst_mod.make_scst_update(model, cfg.train,
                                       start_id=vocab.start)
    finally:
        scst_mod.make_optimizer = real
    fn(state, batch, toks, mask, adv)
    return kept


def _scst_step_split(rollout_fn, update_fn, rewarder, state, batches,
                     dev) -> dict:
    """Serial steps with the host clock around each part: the rollout
    (both legs, until its tokens reached the host), the host reward, the
    update (synchronized); ms a step over the steps after the first."""
    import torch

    from captionkit_torch.train.scst import host_tokens

    parts = {"rollout": [], "reward": [], "update": [], "step": []}
    for i, (batch, _, ids) in enumerate(batches):
        gen = torch.Generator(device=dev).manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roll = rollout_fn(state.params, batch, gen)
        s_tok = host_tokens(roll, "sample_tokens")
        g_tok = host_tokens(roll, "greedy_tokens")
        t1 = time.perf_counter()
        adv = rewarder.advantage(s_tok, g_tok, ids)
        t2 = time.perf_counter()
        state, m = update_fn(state, batch, roll["sample_tokens"],
                             roll["sample_mask"],
                             torch.from_numpy(adv).to(dev))
        check(bool(torch.isfinite(m["scst_loss"])), f"loss {m}")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, a, b in (("rollout", t0, t1), ("reward", t1, t2),
                          ("update", t2, t3), ("step", t0, t3)):
            parts[key].append(1e3 * (b - a))
    return {"state": state, **{f"{k}_ms": statistics.mean(v[1:])
                               for k, v in parts.items()},
            "ms_steps": parts["step"]}


def _reward_turns(rewarder, vocab, s_tok, g_tok, refs, ids,
                  rounds=3) -> dict:
    """The rewarder's advantage (both legs in one native call against the
    references' ids) against the one-set-at-a-time path it replaced
    (``Vocab.decode`` row by row, each leg scored alone with its
    references interned again), in turns on one batch: host ms of each
    and whether the advantages are bit-equal."""
    import numpy as np

    native = rewarder._native

    def one_at_a_time():
        legs = [native.score([vocab.decode(r) for r in t],
                             [list(r) for r in refs]) for t in (s_tok, g_tok)]
        return (legs[0] - legs[1]).astype(np.float32)

    runs = {"sets": [], "one_at_a_time": []}
    for _ in range(rounds):
        for name, fn in (("sets", lambda: rewarder.advantage(s_tok, g_tok,
                                                             ids)),
                         ("one_at_a_time", one_at_a_time)):
            t0 = time.perf_counter()
            fn()
            runs[name].append(1e3 * (time.perf_counter() - t0))
    equal = bool(np.array_equal(rewarder.advantage(s_tok, g_tok, ids),
                                one_at_a_time()))
    check(equal, "the set scorer's advantages differ from one at a time")
    return {"ms": {k: statistics.median(v) for k, v in runs.items()},
            "runs": runs, "bit_equal": equal}


def _reward_at_reference_length(rewarder, vocab, refs, ids, max_len,
                                rounds=3) -> dict:
    """The rewarder's advantage with both legs replaced by the batch's own
    reference captions (each image's first as the sample, its second as
    the greedy baseline, cut to ``max_len`` tokens): host ms a call at the
    length of real captions, which a barely trained model's greedy leg
    does not reach. Also the mean words a leg."""
    import numpy as np

    legs = [np.array([vocab.encode(r[j], max_len, add_bos_eos=False)[0]
                      for r in refs], np.int32) for j in (0, 1)]
    runs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rewarder.advantage(legs[0], legs[1], ids)
        runs.append(1e3 * (time.perf_counter() - t0))
    words = [statistics.mean(len(vocab.decode(r)) for r in t) for t in legs]
    return {"ms": statistics.median(runs), "runs": runs,
            "mean_words": {"sample": words[0], "greedy": words[1]}}


def profile_scst(prep: str, xe_npz: str) -> None:
    """``chip_smoke.py --profile-scst PREP XE.npz``: two serial
    ``scst_train`` steps under torch.profiler, in a process of its own;
    prints one JSON line (device time, busy share, top device ops)."""
    import torch

    from captionkit_torch.metrics.cider import NgramDocFreq
    from captionkit_torch.train.scst import ScstRewarder, scst_train_step

    dev = torch.device(TRAIN_DEVICE)
    cfg, model, ds, state = _scst_setup(prep, xe_npz)
    rollout_fn, update_fn = _scst_fns(model, cfg, ds.vocab)
    rewarder = ScstRewarder(ds.vocab, NgramDocFreq.build(ds.references))
    batches = _scst_batches(ds, cfg, 3, dev, rewarder)
    holder = {"state": state}

    def step(i):
        holder["state"], _ = scst_train_step(
            rollout_fn=rollout_fn, update_fn=update_fn, rewarder=rewarder,
            state=holder["state"], batch=batches[i][0],
            references=batches[i][2],
            generator=torch.Generator(device=dev).manual_seed(i))

    step(0)
    torch.cuda.synchronize()

    def run():
        for i in (1, 2):
            step(i)
        torch.cuda.synchronize()

    prof = _profile(run, top=12)
    prof["steps"] = 2
    print(json.dumps(prof), flush=True)


def phase_scst(wrappers, card) -> dict:
    """SCST fine-tuning (``scst_train``: EditNet at paper width, batch 256,
    bf16) from the train phase's exported XE weights on its synthetic
    split: the greedy leg bit-equal to ``greedy_decode`` on the same
    context; the native rewards within 1e-9 of the Python ``CiderD``; the
    update's gradients (deferred backward) against autograd through the
    plain loop at the train phase's bars, with a dropped ``lang_wrc`` term
    and a flipped advantage that must fail; ms a step split into rollout,
    reward and update, and the reward again with both legs replaced by
    reference captions (the XE weights' greedy leg stops early); serial
    and pipelined ``run_scst_training`` in turns; peak memory of a step
    with 1 and 4 samples; ``cli train-scst`` for a few steps with
    validation (launches counted); its export decoded by ``cli decode``;
    ``dcnet_scst_train`` for a few steps through the CLI; a profile of two
    steps in a process of its own."""
    import numpy as np
    import torch

    from captionkit_torch.decode.greedy import greedy_decode
    from captionkit_torch.metrics.cider import CiderD, NgramDocFreq
    from captionkit_torch.models import editnet_backward, get_model
    from captionkit_torch.params import named_tensors, params_from_tensors
    from captionkit_torch.train.loop import run_scst_training
    from captionkit_torch.train.scst import ScstRewarder, host_tokens

    dev = torch.device(TRAIN_DEVICE)
    root = SMOKE_DIR / "train"
    prep, xe = root / "prepared", root / "full.npz"
    cfg, model, ds, state = _scst_setup(prep, xe)
    vocab = ds.vocab
    df = NgramDocFreq.build(ds.references)
    rewarder = ScstRewarder(vocab, df)
    rollout_fn, update_fn = _scst_fns(model, cfg, vocab)
    batches = _scst_batches(ds, cfg, 2 + SCST_STEPS, dev, rewarder)

    # 1. The rollout: the greedy leg against greedy_decode on the same
    # context; the rewards against the Python CiderD.
    batch, refs, ids = batches[0]
    roll = rollout_fn(state.params, batch,
                      torch.Generator(device=dev).manual_seed(0))
    check(roll["sample_tokens"].grad_fn is None, "the rollout kept a graph")
    with torch.no_grad():
        fresh = params_from_tensors({n: t.detach() for n, t in
                                     named_tensors(state.params).items()},
                                    state.params)
        ctx = model.encode(fresh, batch["features"], batch["existing"],
                           batch["existing_len"])
        greedy = greedy_decode(model, fresh, ctx, start_id=vocab.start,
                               end_id=vocab.end, pad_id=vocab.pad,
                               max_len=cfg.decode.max_decode_len).tokens
    check(torch.equal(greedy, roll["greedy_tokens"]),
          "the greedy leg differs from greedy_decode on the same context")
    s_tok = host_tokens(roll, "sample_tokens")
    g_tok = host_tokens(roll, "greedy_tokens")
    reward_err = 0.0
    for toks in (s_tok, g_tok):
        hyps = [vocab.decode(r) for r in toks]
        native = rewarder._native.score(hyps, refs)
        _, py = CiderD(df).compute(hyps, refs)
        reward_err = max(reward_err, float(np.abs(native - py).max()))
    check(reward_err <= 1e-9, f"native rewards off CiderD by {reward_err}")
    reward_turns = _reward_turns(rewarder, vocab, s_tok, g_tok, refs, ids)
    reward_ref_len = _reward_at_reference_length(
        rewarder, vocab, refs, ids, cfg.decode.max_decode_len)
    adv = torch.from_numpy(rewarder.advantage(s_tok, g_tok, ids)).to(dev)
    sample_len = float(roll["sample_mask"].float().sum(1).mean())
    leg_words = {name: statistics.mean(len(vocab.decode(r)) for r in t)
                 for name, t in (("sample", s_tok), ("greedy", g_tok))}

    # 2. The update's gradients: the deferred backward against autograd
    # through the plain loop, with planted faults.
    m_auto = get_model(cfg.override({"model.deferred_backward": False})
                       .model)
    args = (batch, roll["sample_tokens"], roll["sample_mask"])
    want = _scst_grads(m_auto, cfg, vocab, state, *args, adv)
    got = _scst_grads(model, cfg, vocab, state, *args, adv)
    errors = _grad_errors(got, want)
    failing = _grad_check_fails(errors)
    check(not failing, f"SCST gradients off autograd: "
                       f"{ {n: errors[n] for n in failing} }")
    editnet_backward.PLANTED_FAULT = "lang_wrc"
    try:
        planted = _grad_check_fails(_grad_errors(_scst_grads(
            model, cfg, vocab, state, *args, adv), want))
    finally:
        editnet_backward.PLANTED_FAULT = None
    check(planted == ["lang_lstm/wrc"],
          f"the dropped lang_wrc term was not caught: {planted}")
    flipped = _grad_check_fails(_grad_errors(_scst_grads(
        model, cfg, vocab, state, *args, -adv), want))
    check(len(flipped) > 0, "a flipped advantage passes the gradient bar")
    del want, got, m_auto
    torch.cuda.empty_cache()

    # 3. ms a step and its split (serial), then serial against pipelined
    # run_scst_training in turns.
    split = _scst_step_split(rollout_fn, update_fn, rewarder, state,
                             batches[1:], dev)
    state = split.pop("state")
    turns = {"serial": [], "pipelined": []}
    for rnd in range(2):
        for mode in (("serial", "pipelined") if rnd == 0
                     else ("pipelined", "serial")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, rep = run_scst_training(
                model, state, cfg.override({"train.scst_epochs": 1}), ds,
                None, max_steps=SCST_STEPS, pipeline=mode == "pipelined",
                device=dev)
            torch.cuda.synchronize()
            turns[mode].append(1e3 * (time.perf_counter() - t0)
                               / SCST_STEPS)
            check(np.isfinite(rep.history[0]["mean_advantage"]),
                  f"{mode} run: {rep.history}")

    # 4. Peak memory of one step with 1 and 4 samples.
    from captionkit_torch.train.scst import scst_train_step

    peak = {}
    for n in (1, 4):
        cfg_n = cfg.override({"train.scst_num_samples": n})
        r_fn, u_fn = _scst_fns(model, cfg_n, vocab, n)
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        state, m = scst_train_step(
            rollout_fn=r_fn, update_fn=u_fn, rewarder=rewarder, state=state,
            batch=batch, references=ids,
            generator=torch.Generator(device=dev).manual_seed(n))
        torch.cuda.synchronize()
        peak[f"n={n}"] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "before_gb": base_gb,
                          "grad_norm": float(m["grad_norm"])}
    del state, batches, roll, args, adv, ctx
    torch.cuda.empty_cache()

    # 5. cli train-scst with validation (the main path, launches counted),
    # its export through cli decode, dcnet_scst_train through the CLI.
    common = ["train-scst", "--prepared", prep, "--split", "train",
              "--device", TRAIN_DEVICE, "--max-steps", SCST_STEPS,
              "--set", "train.scst_epochs=1", "--set",
              "train.keep_checkpoints=1", "--set", "train.log_every=1"]
    _reset(wrappers)
    t0 = time.perf_counter()
    cli_out = _cli_in_process(common + [
        "--config", "scst_train", "--params", xe, "--val-split", "val",
        "--set", f"train.checkpoint_dir={root / 'ck_scst'}",
        "--export-params", root / "scst.npz", "--run-dir",
        root / "run_scst"])
    cli_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    check(cli_out["step"] == SCST_STEPS, f"cli train-scst: {cli_out}")
    check(launches["fused_head_topk"] > 0,
          f"the validation launched no head kernel: {launches}")
    rows = [json.loads(x) for x in (root / "run_scst" / "metrics.jsonl")
            .read_text().splitlines()]
    check(any("scst/mean_advantage" in r for r in rows),
          f"metrics.jsonl rows {rows[:3]}")
    t0 = time.perf_counter()
    decoded = _cli("decode", "--config", "editnet_beam5", "--prepared",
                   prep, "--split", "val", "--params", root / "scst.npz",
                   "--set", f"decode.batch_size={N_IMAGES}", "--device",
                   TRAIN_DEVICE)
    decode_cli_s = time.perf_counter() - t0
    check(decoded["captions"] == N_VAL and "CIDEr" in decoded,
          f"decode of the SCST weights: {decoded}")
    t0 = time.perf_counter()
    dc_out = _cli_in_process(common + [
        "--config", "dcnet_scst_train", "--no-val", "--set",
        f"train.checkpoint_dir={root / 'ck_dcnet_scst'}"])
    dc_s = time.perf_counter() - t0
    check(dc_out["step"] == SCST_STEPS and np.isfinite(
        dc_out["history"][0]["mean_advantage"]),
        f"dcnet_scst_train: {dc_out}")

    # 6. A profile of two serial steps, in a process of its own.
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--profile-scst",
         str(prep), str(xe)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    check(proc.returncode == 0, f"scst profile exited {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    result = {
        "phase": "scst", "ok": True, "card": card, "config": "scst_train",
        "batch": cfg.data.batch_size, "from": "the train phase's export",
        "greedy_leg_bit_equal": True, "reward_max_abs_err": reward_err,
        "reward_turns": reward_turns,
        "reward_at_reference_length": reward_ref_len,
        "sample_len": sample_len, "leg_mean_words": leg_words,
        "grad_check": {"rtol": GRAD_RTOL, "rtol_floor": GRAD_RTOL_FLOOR,
                       "max_rel_err": max(e for n, e in errors.items()
                                          if n not in GRAD_FLOOR),
                       "max_rel_err_floor": max(errors[n]
                                                for n in GRAD_FLOOR),
                       "planted_lang_wrc_caught": True,
                       "flipped_advantage_fails": flipped[:5]},
        "step": split, "turns_ms_a_step": turns,
        "turns_mean_ms": {k: statistics.mean(v) for k, v in turns.items()},
        "memory": peak, "cli_s": cli_s, "cli": {
            k: cli_out[k] for k in ("step", "best_val_cider", "history")},
        "launches": launches, "export_decode": {
            "cli_s": decode_cli_s, "cider": decoded["CIDEr"]},
        "dcnet_scst_train": {"cli_s": dc_s, "history": dc_out["history"]},
        "profile": prof}
    emit(result)
    return result


def _ensemble_plain_head(params, ctx_k, state, k=BEAM):
    """The plain head on the members' hiddens concatenated, over the
    prepared combined head (bf16 W_m/M stacked, mean bias)."""
    from captionkit_torch.kernels.head import reference_head_topk

    h = state.h_lang.reshape(state.h_lang.shape[0], -1)
    return reference_head_topk(h.to(ctx_k.head_w.dtype), ctx_k.head_w,
                               ctx_k.head_b, k)


def phase_ensemble(ed, dc, wrappers, card) -> dict:
    """Checkpoint ensembles and stacked editing at paper width (the wide
    tiled heads were held in ``wide_head``): editnet_beam5 as a two-member
    logprob ensemble (seeds 0 and 1 through the .npz bridge) behind
    CaptionServer(batch=512); a forced-full decode with 22 launches of
    fused_head_topk a batch at H' = 2048, captions/s in turns beside the
    single model; the combined head against its plain version on the
    decode's own states; two copies of one checkpoint against the single
    model; the int8, thresh and prob ensembles decoded once each; then
    ``serve --stacked``'s pipeline (dcnet_beam5's DCNet greedy, then
    EditNet beam) at batch 512: served, captions/s in turns beside
    EditNet alone, 0 kernel launches in stage 1 and 22 head launches a
    batch in stage 2."""
    import dataclasses

    import torch

    from captionkit_torch.decode import greedy_decode, make_decode_fn
    from captionkit_torch.decode.stacked import make_stacked_decode_fn
    from captionkit_torch.models import get_model
    from captionkit_torch.models.ensemble import ensemble_model, stack_params
    from captionkit_torch.params import load_params_npz, save_params_npz

    cfg, model, params, vocab = ed
    npz1 = SMOKE_DIR / "params_editnet_seed1.npz"
    save_params_npz(model.init(1, "cpu"), str(npz1))
    second = load_params_npz(str(npz1), "cuda", arch="editnet")
    ep = stack_params([params, second])
    ens = ensemble_model(model, 2)
    serve = phase_serve(cfg, ens, ep, vocab, wrappers, ("fused_head_topk",),
                        phase="ensemble_serve")

    batch = _batch(cfg.model)
    kw = dict(start_id=vocab.start, end_id=-1, pad_id=vocab.pad,
              device="cuda")
    decode = make_decode_fn(model, cfg.decode, **kw)
    ens_decode = make_decode_fn(ens, cfg.decode, **kw)
    ens_decode(ep, *batch).cpu()  # warm-up
    _reset(wrappers)
    tokens = ens_decode(ep, *batch).cpu()
    per_batch = {w.__name__: w.launches for w in wrappers}
    check(per_batch["fused_head_topk"] == MAX_LEN,
          f"{per_batch} launches for one ensemble batch")
    check(tuple(tokens.shape) == (N_IMAGES, MAX_LEN),
          f"tokens {tuple(tokens.shape)}")
    timed = _timed_decodes(
        {"ensemble2": lambda _p, *b: ens_decode(ep, *b),
         "single": lambda _p, *b: decode(params, *b)},
        {"ensemble2": batch, "single": batch}, None)
    steps = _check_steps(ens, ep, [t.cuda() for t in batch], kw,
                         plain=_ensemble_plain_head)
    single = decode(params, *batch).cpu()
    dup = make_decode_fn(ens, cfg.decode, **kw)(
        stack_params([params, params]), *batch).cpu()
    dup_agree = float((dup == single).float().mean())
    check(dup_agree >= 0.5, f"two copies of one checkpoint agree with it "
                            f"on {dup_agree} < 0.5")
    others = {}
    for name, sets, mode, expect in (
            ("int8", {"model.head_quant": "int8"}, "logprob",
             "fused_head_topk_int8"),
            ("thresh", {"model.head_extract": "thresh"}, "logprob",
             "fused_head_topk_thresh"),
            ("prob", {}, "prob", None)):
        m = ensemble_model(get_model(cfg.override(sets).model), 2,
                           mode=mode)
        fn = make_decode_fn(m, cfg.decode, **kw)
        fn(ep, *batch).cpu()
        _reset(wrappers)
        t0 = time.perf_counter()
        toks = fn(ep, *batch).cpu()
        wall = time.perf_counter() - t0
        launched = {w.__name__: w.launches for w in wrappers}
        if expect is None:
            check(sum(launched.values()) == 0,
                  f"prob mode launched head kernels: {launched}")
        else:
            check(launched[expect] == MAX_LEN,
                  f"{name} ensemble launches: {launched}")
        check(bool(((toks >= 0) & (toks < cfg.model.vocab_size)).all()),
              f"{name} ensemble token ids out of range")
        others[name] = {"launches_per_batch": launched,
                        "captions_per_s": N_IMAGES / wall,
                        "token_agreement_with_logprob": float(
                            (toks == tokens).float().mean())}

    # The stacked pipeline: DCNet (dcnet_beam5's weights, plain cells)
    # greedy, then EditNet beam.
    dcfg, _, dparams, _ = dc
    dmodel = get_model(dataclasses.replace(cfg.model, arch="dcnet"))
    first = dataclasses.replace(cfg.decode, method="greedy", beam_size=1)
    stacked = make_stacked_decode_fn(
        dmodel, model, first_stage=first, second_stage=cfg.decode,
        start_id=vocab.start, end_id=vocab.end, pad_id=vocab.pad,
        feed_dtype=cfg.decode.feed_dtype, device="cuda")
    pair = (dparams, params)
    sserve = phase_serve(
        cfg, model, pair, vocab, wrappers, ("fused_head_topk",),
        phase="stacked_serve",
        decode_fn=lambda p, f, i, n, _s: stacked(p[0], p[1], f, i, n))
    forced = make_stacked_decode_fn(
        dmodel, model, first_stage=first, second_stage=cfg.decode,
        start_id=vocab.start, end_id=-1, pad_id=vocab.pad, device="cuda")
    forced(dparams, params, *batch).cpu()
    _reset(wrappers)
    with torch.inference_mode():
        feats, existing, lens = (t.cuda() for t in batch)
        g = greedy_decode(dmodel, dparams, dmodel.encode(
            dparams, feats, existing, lens), start_id=vocab.start,
            end_id=-1, pad_id=vocab.pad, max_len=MAX_LEN)
        torch.cuda.synchronize()
    stage1 = {w.__name__: w.launches for w in wrappers}
    check(sum(stage1.values()) == 0, f"stage 1 launched {stage1}")
    check(tuple(g.tokens.shape) == (N_IMAGES, MAX_LEN), "stage 1 shape")
    _reset(wrappers)
    stoks = forced(dparams, params, *batch).cpu()
    stacked_launches = {w.__name__: w.launches for w in wrappers}
    check(stacked_launches["fused_head_topk"] == MAX_LEN
          and sum(stacked_launches.values()) == MAX_LEN,
          f"stacked batch launched {stacked_launches}")
    check(tuple(stoks.shape) == (N_IMAGES, MAX_LEN), "stacked shape")
    stimed = _timed_decodes(
        {"stacked": lambda _p, *b: forced(dparams, params, *b),
         "editnet": lambda _p, *b: decode(params, *b)},
        {"stacked": batch, "editnet": batch}, None)
    result = {
        "phase": "ensemble", "ok": True, "card": card,
        "config": "editnet_beam5", "members": 2, "mode": "logprob",
        "H_combined": 2 * cfg.model.hidden_dim, "batch": N_IMAGES,
        "serve_launches": serve["launches"], "launches_per_batch":
        per_batch, "captions_per_s": timed, "steps_check": steps,
        "duplicate_token_agreement": dup_agree, "variants": others,
        "stacked": {"serve_launches": sserve["launches"],
                    "serve_wall_s": sserve["wall_s"],
                    "stage1_launches": stage1,
                    "launches_per_batch": stacked_launches,
                    "captions_per_s": stimed}}
    emit(result)
    return result


# --------------------------------------------------------------------------
# The checkpoint converter and the parity gate; attention introspection
# --------------------------------------------------------------------------

N_GATE = 512  # test images of the convert phase's split
GATE_IMAGES = 64  # --max-images: the greedy checks' images


def _scrambled(arch: str, sd) -> dict:
    """``sd`` with module names only a shape fit recovers: every EditNet
    module renamed; DCNet's modules of unique shape renamed (its three
    [H, H] linears keep the names that break their tie)."""
    rename = ({"embedding": "blk0", "encoder": "blk1", "att_lstm": "blk2",
               "vis_attention": "blk3", "f_beta": "blk4", "scma": "blk5",
               "lang_lstm": "blk6", "fc": "blk7"} if arch == "editnet" else
              {"embedding": "word_emb", "encoder": "cap_encoder",
               "decode_step": "decoder_cell", "fc": "logits_out"})
    out = {}
    for k, v in sd.items():
        head, dot, rest = k.partition(".")
        out[rename.get(head, head) + dot + rest] = v
    return out


def _swap_if_blocks(w):
    """A torch LSTM weight [4H, in] with its i and f gate blocks swapped."""
    import torch

    H = w.shape[0] // 4
    return torch.cat([w[H:2 * H], w[:H], w[2 * H:]])


def _greedy_agreement(ours, twin_seqs) -> float:
    """Share of the twin's tokens (up to its end) that ours equal."""
    same = total = 0
    for row, seq in zip(ours, twin_seqs):
        same += sum(int(a == b) for a, b in zip(row[:len(seq)], seq))
        total += len(seq)
    return same / max(total, 1)


def _twin_gap(twin, arch, ds, image, prefix) -> float:
    """The twin's top-2 logit gap for ``image`` after ``prefix`` (the
    tokens before the first differing step)."""
    import numpy as np
    import torch

    dev = next(twin.parameters()).device

    def t(a):
        return torch.from_numpy(np.asarray(a)[image:image + 1]).to(dev)

    with torch.no_grad():
        ex, ln = t(ds.existing).long(), t(ds.existing_len).long()
        feats = ds.features[np.asarray(ds.image_index[image:image + 1])]
        tctx = (twin.encode(ex, ln) if arch == "dcnet" else twin.encode(
            torch.from_numpy(np.asarray(feats, np.float32)).to(dev), ex,
            ln))
        state = list(twin.init_state(tctx))
        tok = torch.full((1,), ds.vocab.start, dtype=torch.long, device=dev)
        for nxt in [*prefix, None]:
            out = twin.step(tctx, *state, tok)
            state, logits = list(out[:-1]), out[-1]
            if nxt is not None:
                tok = torch.full((1,), nxt, dtype=torch.long, device=dev)
        top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def _check_gate(rep: dict, what: str, twins=None, ds=None) -> None:
    """The fp32 gate's bar: ok, greedy identical on GATE_IMAGES images,
    a finite beam CIDEr. On a greedy mismatch the twin's top-2 gap at the
    first differing step is part of the failure."""
    import math

    greedy = rep["checks"].get("greedy_identical", {})
    if greedy.get("status") == "fail" and twins is not None:
        m = greedy["mismatches"][0]
        k = next(i for i, (a, b) in enumerate(zip(m["ours"], m["twin"]))
                 if a != b)
        gap = _twin_gap(twins[rep["arch"]], rep["arch"], ds, m["image"],
                        m["twin"][:k])
        raise PhaseError(f"{what}: greedy differs from the twin at image "
                         f"{m['image']} step {k}; the twin's top-2 logit "
                         f"gap there is {gap:.3e}: {greedy}")
    check(rep["ok"] is True, f"{what}: gate not ok: {rep['checks']}")
    check(greedy.get("status") == "pass"
          and greedy.get("images") == GATE_IMAGES,
          f"{what}: greedy_identical {greedy}")
    beam = rep["checks"]["beam_cider"]
    check(beam["status"] == "pass" and math.isfinite(beam["cider"]),
          f"{what}: beam_cider {beam}")


def phase_convert(wrappers, card) -> dict:
    """The checkpoint converter and the parity gate at paper width: a
    synthetic prepared split from seed 0 (N_GATE test images, 5
    references each, a 9,490-word wordmap); EditNet and DCNet torch twins
    from the port's torch_ref with seed 0, each saved as a bare state
    dict, as the released training dict {epoch, decoder: <module>} and
    with scrambled module names; ``cli convert`` of each (the scrambled
    one with --fit-names) in processes of their own, all at once: the
    three .npz of an arch array-equal; ``cli parity-gate --set
    model.compute_dtype=float32 --max-images 64`` in processes of their
    own, with and without --fit-names: ok, greedy identical on 64 of 64,
    beam CIDEr; the EditNet gate again in this process on the training
    dict, launches counted: the beam launches fused_head_topk at most
    MAX_LEN times a batch; planted faults: the i and f gate blocks of
    EditNet's lang_lstm.base.weight_ih (DCNet's decode_step.weight_ih)
    swapped in the converted state dict must disagree with the true
    twin's greedy tokens, where the sound weights agree on all; the same
    gate at the default bf16: token agreement with the twin, reported."""
    import shutil

    import numpy as np
    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.convert import gate
    from captionkit_torch.convert.torch_import import load_torch_state_dict
    from captionkit_torch.convert.torch_ref import TorchDCNet, TorchEditNet
    from captionkit_torch.convert.torch_import import params_from_state_dict
    from captionkit_torch.data.prepare import load_prepared_split
    from captionkit_torch.models import get_model

    dev = torch.device("cuda")
    root = SMOKE_DIR / "convert"
    shutil.rmtree(root, ignore_errors=True)
    try:
        cfgs = {a: get_named_config(f"{a}_beam5").override(
                    {"decode.batch_size": N_IMAGES})
                for a in ("editnet", "dcnet")}
        mc = cfgs["editnet"].model
        V = mc.vocab_size
        t0 = time.perf_counter()
        made = _write_karpathy(root, V, n_test=N_GATE)
        paths = made["paths"]
        _cli_in_process(["prepare", "--karpathy", paths["karpathy"],
                         "--out", root / "prepared",
                         "--existing", f"train={paths['existing_train']}",
                         "--existing", f"test={paths['existing_test']}",
                         "--features", f"test={paths['features']}"])
        paths["features"].unlink()
        prep = root / "prepared"
        ds = load_prepared_split(str(prep), "test",
                                 max_len=cfgs["editnet"].data.max_len)
        ev = ds.eval_view()  # the rows the gate's greedy checks read
        check(len(ds.vocab) == V and ev.size == N_GATE,
              f"split of {ev.size} images, wordmap {len(ds.vocab)}")
        split_s = time.perf_counter() - t0

        # Twins, seed 0, and their three checkpoint files each.
        t0 = time.perf_counter()
        twins, ckpts = {}, {}
        for arch, cls in (("editnet", TorchEditNet), ("dcnet", TorchDCNet)):
            m = cfgs[arch].model
            torch.manual_seed(0)
            twin = (cls(V, m.emb_dim, m.hidden_dim, m.att_dim, m.feat_dim)
                    if arch == "editnet" else
                    cls(V, m.emb_dim, m.hidden_dim, m.att_dim)).eval()
            twins[arch] = twin
            sd = twin.state_dict()
            ckpts[arch] = {"bare": root / f"{arch}_bare.pth",
                           "train": root / f"{arch}_train.pth.tar",
                           "scrambled": root / f"{arch}_scrambled.pth"}
            torch.save(sd, ckpts[arch]["bare"])
            torch.save({"epoch": 0, "decoder": twin}, ckpts[arch]["train"])
            torch.save(_scrambled(arch, sd), ckpts[arch]["scrambled"])
        save_s = time.perf_counter() - t0

        # cli convert, six processes at once.
        procs = {}
        for arch in ckpts:
            for kind, ck in ckpts[arch].items():
                argv = ["convert", "--torch", ck, "--arch", arch, "--out",
                        root / f"{arch}_{kind}.npz"]
                if kind == "scrambled":
                    argv += ["--fit-names", "--config", f"{arch}_beam5"]
                procs[(arch, kind)] = (time.perf_counter(), subprocess.Popen(
                    [sys.executable, "-m", "captionkit_torch.cli",
                     *map(str, argv)], cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
        convert_s = {}
        for (arch, kind), (start, proc) in procs.items():
            out, err = proc.communicate(timeout=600)
            convert_s[f"{arch}_{kind}"] = time.perf_counter() - start
            check(proc.returncode == 0,
                  f"convert {arch} {kind} exited {proc.returncode}: "
                  f"{err[-2000:]}")
        arrays = {}
        for arch in ckpts:
            files = [np.load(root / f"{arch}_{kind}.npz") for kind in
                     ("bare", "train", "scrambled")]
            names = sorted(files[0].files)
            for f in files[1:]:
                check(sorted(f.files) == names, f"{arch}: npz names differ")
                for n in names:
                    check(np.array_equal(f[n], files[0][n]),
                          f"{arch}: {n} differs between the converted files")
            arrays[arch] = {"names": len(names), "floats": int(sum(
                files[0][n].size for n in names))}
            for f in files:
                f.close()

        # cli parity-gate: EditNet alone (its split timed), then the
        # other three at once.
        def gate_argv(arch, ck, fit):
            return ["parity-gate", "--config", f"{arch}_beam5",
                    "--prepared", prep, "--split", "test", "--ckpt", ck,
                    "--device", "cuda", "--set",
                    "model.compute_dtype=float32", "--set",
                    f"decode.batch_size={N_IMAGES}", "--max-images",
                    GATE_IMAGES, *(["--fit-names"] if fit else [])]

        def run_gates(runs):
            started = {name: (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "captionkit_torch.cli",
                 *map(str, argv)], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
                for name, argv in runs.items()}
            out = {}
            for name, (start, proc) in started.items():
                stdout, err = proc.communicate(timeout=900)
                wall = time.perf_counter() - start
                check(stdout.strip().startswith("{"),
                      f"gate {name} exited {proc.returncode}: "
                      f"{err[-3000:]}")
                rep = json.loads(stdout)
                rep["wall_s"] = wall
                rep["returncode"] = proc.returncode
                out[name] = rep
            return out

        reports = run_gates({"editnet": gate_argv(
            "editnet", ckpts["editnet"]["train"], False)})
        reports.update(run_gates({
            "editnet_fit": gate_argv("editnet",
                                     ckpts["editnet"]["scrambled"], True),
            "dcnet": gate_argv("dcnet", ckpts["dcnet"]["bare"], False),
            "dcnet_fit": gate_argv("dcnet", ckpts["dcnet"]["scrambled"],
                                   True)}))
        for name, rep in reports.items():
            _check_gate(rep, f"gate {name}", twins, ev)
            check(rep["returncode"] == 0, f"gate {name} exited "
                                          f"{rep['returncode']}")
            if name.endswith("_fit"):
                check(rep["fit"]["candidate"] == 0,
                      f"gate {name}: fit {rep['fit']}")

        # In this process: the sound fp32 EditNet gate on the training
        # dict, its launches counted (the beam stops once every beam has
        # finished, so a batch launches the head at most MAX_LEN times).
        f32 = {a: c.override({"model.compute_dtype": "float32"})
               for a, c in cfgs.items()}
        _reset(wrappers)
        t0 = time.perf_counter()
        rep32 = gate.run_parity_gate(str(ckpts["editnet"]["train"]),
                                     f32["editnet"], ds,
                                     max_images=GATE_IMAGES, device=dev)
        rep32["wall_s"] = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        _check_gate(rep32, "gate editnet (this process)", twins, ev)
        want = MAX_LEN * -(-N_GATE // N_IMAGES)
        check(0 < launches["fused_head_topk"] <= want,
              f"the gate's beam launched {launches}, want 1 to {want} "
              "fused_head_topk")

        # Planted faults: the i and f gate blocks of the LSTM's input
        # weight swapped in the converted state dict. Against the true
        # twin's greedy tokens, the sound weights agree on every token
        # and the faulty ones must not.
        n = GATE_IMAGES
        feats = np.asarray(ev.features[np.asarray(ev.image_index[:n])],
                           np.float32)
        twin_seqs, planted = {}, {}
        for arch, key in (("editnet", "lang_lstm.base.weight_ih"),
                          ("dcnet", "decode_step.weight_ih")):
            twin_seqs[arch] = gate._twin_greedy(
                twins[arch].to(dev), arch, feats, np.asarray(ev.existing[:n]),
                np.asarray(ev.existing_len[:n]), start_id=ds.vocab.start,
                end_id=ds.vocab.end, max_len=MAX_LEN)
            twins[arch].cpu()
            raw = load_torch_state_dict(str(ckpts[arch]["bare"]))
            faulty = dict(raw, **{key: _swap_if_blocks(raw[key])})
            agree = {kind: _greedy_agreement(gate._greedy_tokens(
                         get_model(f32[arch].model),
                         params_from_state_dict(sd, arch, device=dev), ev, n,
                         start_id=ds.vocab.start, end_id=ds.vocab.end,
                         max_len=MAX_LEN, device=dev), twin_seqs[arch])
                     for kind, sd in (("sound", raw), ("faulty", faulty))}
            check(agree["sound"] == 1.0,
                  f"{arch}: fp32 greedy agreement with the twin "
                  f"{agree['sound']}")
            check(agree["faulty"] < 1.0,
                  f"{arch}: swapped i/f gate blocks agree with the twin")
            planted[arch] = {f"{kind}_token_agreement_with_twin": a
                             for kind, a in agree.items()}

        # The default bf16 against the fp32 twin: reported, not gated.
        t0 = time.perf_counter()
        rep16 = gate.run_parity_gate(str(ckpts["editnet"]["bare"]),
                                     cfgs["editnet"], ds,
                                     max_images=GATE_IMAGES, device=dev)
        bf16_s = time.perf_counter() - t0
        params = params_from_state_dict(
            load_torch_state_dict(str(ckpts["editnet"]["bare"])), "editnet",
            device=dev)
        agree16 = _greedy_agreement(gate._greedy_tokens(
            get_model(cfgs["editnet"].model), params, ev, n,
            start_id=ds.vocab.start, end_id=ds.vocab.end, max_len=MAX_LEN,
            device=dev), twin_seqs["editnet"])
        result = {
            "phase": "convert", "ok": True, "card": card,
            "configs": ["editnet_beam5", "dcnet_beam5"],
            "test_images": N_GATE, "greedy_images": GATE_IMAGES,
            "vocab": V, "split_s": split_s, "twin_save_s": save_s,
            "convert_cli_s": convert_s, "converted": arrays,
            "gates": {name: {"ok": rep["ok"], "wall_s": rep["wall_s"],
                             "seconds": rep["seconds"],
                             "greedy_identical":
                             rep["checks"]["greedy_identical"]["images"],
                             "beam_cider": rep["checks"]["beam_cider"],
                             **({"fit": {k: rep["fit"][k] for k in
                                         ("candidate", "of")},
                                 "fit_warning": "warning" in rep["fit"]}
                                if "fit" in rep else {})}
                      for name, rep in {**reports,
                                        "editnet_in_process": rep32}.items()},
            "planted_if_swap": planted,
            "launches": launches,
            "gate_batches": -(-N_GATE // N_IMAGES),
            "bf16": {"greedy_identical":
                     rep16["checks"]["greedy_identical"]["status"],
                     "beam_cider": rep16["checks"]["beam_cider"],
                     "seconds": rep16["seconds"], "wall_s": bf16_s,
                     "token_agreement_with_twin": agree16,
                     "meets_0_5": agree16 >= 0.5}}
        emit(result)
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _turns(fns: dict, rounds: int = 2) -> dict:
    """captions/s of each named zero-argument decode (N_IMAGES captions a
    call, host clock to a synchronize), in turns: a, b, b, a, ..."""
    import torch

    out = {name: [] for name in fns}
    names = list(fns)
    for r in range(2 * rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            out[name].append(N_IMAGES / (time.perf_counter() - t0))
    return {name: {"captions_per_s": statistics.median(r), "runs": r}
            for name, r in out.items()}


def _check_trace(trace, mask, what) -> dict:
    """Every distribution of an emitted step sums to 1 within 1e-3; the
    existing caption's masked positions get exactly 0."""
    import torch

    emitted = trace.rollout.mask
    sums = {}
    for key, arr in trace.attention.items():
        err = float((arr.sum(-1) - 1.0).abs()[emitted].max())
        check(err <= 1e-3, f"{what}: {key} sums off 1 by {err}")
        sums[key] = err
        if key != "vis_alpha":
            pad = ~mask.bool()[:, None, :].expand_as(arr)
            check(bool((arr[pad] == 0.0).all()),
                  f"{what}: {key} weights on masked positions")
    check(bool(torch.isfinite(trace.rollout.logprobs).all()),
          f"{what}: log-probs not finite")
    return sums


def phase_introspect(ed, wrappers, card) -> dict:
    """Attention introspection at paper width on the serve phase's
    weights (params_editnet.npz, params_dcnet.npz), batch 512, bf16, 22
    steps, the end id enabled: editnet_beam5's greedy trace bit-equal to
    greedy_decode, its beam trace (K = 5) bit-equal to beam_search over the
    full logits under register and backptr, beside beam_search with the
    plain head (head_impl="xla") and the kernel decode (token agreement);
    every distribution summing to 1, masked positions 0, no kernel launch
    by a trace; the two-member ensemble's trace the mean of its members'
    traces on its tokens; dcnet_greedy's trace against greedy_decode; one
    image's attention_report; captions/s of each traced decode beside the
    untraced ones, in turns."""
    import dataclasses

    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.decode import (
        attention_report,
        beam_decode_with_attention,
        beam_search,
        greedy_decode,
        greedy_decode_with_attention,
    )
    from captionkit_torch.models import get_model
    from captionkit_torch.models.ensemble import ensemble_model, stack_params
    from captionkit_torch.params import load_params_npz, save_params_npz

    cfg, model, params, vocab = ed
    dev = torch.device("cuda")
    feats, existing, lens = (t.to(dev) for t in _batch(cfg.model))
    kw = dict(start_id=vocab.start, end_id=vocab.end, pad_id=vocab.pad,
              max_len=MAX_LEN)
    bkw = dict(beam_size=BEAM, **kw)
    out = {}
    with torch.inference_mode():
        ctx = model.encode(params, feats, existing, lens)

        # Greedy: the trace's rollout is greedy_decode's, bit for bit.
        plain = greedy_decode(model, params, ctx, **kw)
        _reset(wrappers)
        trace = greedy_decode_with_attention(model, params, ctx, **kw)
        torch.cuda.synchronize()
        traced_launches = {w.__name__: w.launches for w in wrappers}
        check(sum(traced_launches.values()) == 0,
              f"the greedy trace launched {traced_launches}")
        for f in plain._fields:
            check(torch.equal(getattr(plain, f), getattr(trace.rollout, f)),
                  f"greedy trace {f} differs from greedy_decode's")
        out["editnet_greedy"] = {"sum_err": _check_trace(trace, ctx.mask,
                                                         "editnet greedy")}

        # Beam: bit-equal to the full-logits beam search, both layouts.
        _reset(wrappers)
        btrace = beam_decode_with_attention(model, params, ctx, **bkw)
        torch.cuda.synchronize()
        check(sum(w.launches for w in wrappers) == 0,
              "the beam trace launched a kernel")
        full = get_model(dataclasses.replace(cfg.model,
                                             use_fused_head=False))
        xla = get_model(dataclasses.replace(cfg.model, head_impl="xla"))
        for impl in ("register", "backptr"):
            ref = beam_search(full, params, ctx, impl=impl, **bkw)
            for f in ref._fields:
                check(torch.equal(getattr(ref, f),
                                  getattr(btrace.result, f)),
                      f"beam trace {f} differs from the full-logits "
                      f"beam_search ({impl})")
        agree = {}
        for name, m in (("xla_head", xla), ("kernel", model)):
            r = beam_search(m, params, ctx, **bkw)
            agree[name] = {
                "token_agreement": float((r.tokens == btrace.result.tokens)
                                         .float().mean()),
                "tokens_equal": bool(torch.equal(r.tokens,
                                                 btrace.result.tokens)),
                "max_abs_score_diff": float((r.scores - btrace.result.scores)
                                            .abs().max())}
            check(agree[name]["token_agreement"] >= 0.5,
                  f"beam trace against the {name} decode: {agree[name]}")
        out["editnet_beam5"] = {
            "sum_err": _check_trace(btrace, ctx.mask, "editnet beam"),
            "bit_equal_full_logits_beam": ["register", "backptr"],
            "agreement": agree}
        report = attention_report(btrace, 0, vocab, existing[0])
        check(len(report) == int(btrace.rollout.lengths[0]),
              f"attention_report has {len(report)} steps")
        out["attention_report_image0"] = report[:8]

        # The two-member ensemble traces its members' mean attention.
        npz1 = SMOKE_DIR / "params_editnet_seed1.npz"
        if not npz1.exists():
            save_params_npz(model.init(1, "cpu"), str(npz1))
        second = load_params_npz(str(npz1), dev, arch="editnet")
        ens = ensemble_model(model, 2)
        ep = stack_params([params, second])
        ectx = ens.encode(ep, feats, existing, lens)
        etrace = greedy_decode_with_attention(ens, ep, ectx, **kw)
        steps = {}
        for p, c in zip(ep.members, ectx.members):
            state = model.init_state(p, c)
            tok = torch.full((N_IMAGES,), vocab.start, dtype=torch.int32,
                             device=dev)
            for t in range(MAX_LEN):
                state, _, attn = model.step_attn(p, c, state, tok)
                for key, a in attn.items():
                    steps.setdefault(key, []).append(a)
                tok = etrace.rollout.tokens[:, t]
        ens_err = {}
        for key, arr in etrace.attention.items():
            member = torch.stack(steps[key]).reshape(
                2, MAX_LEN, *steps[key][0].shape)
            mean = torch.stack([member[0], member[1]]).mean(dim=0)
            ens_err[key] = float((arr - mean.transpose(0, 1)).abs().max())
            check(ens_err[key] <= 1e-6,
                  f"ensemble {key} off its members' mean by {ens_err[key]}")
        out["ensemble2_greedy"] = {
            "max_abs_err_to_member_mean": ens_err,
            "sum_err": _check_trace(etrace, ectx.members[0].mask,
                                    "ensemble greedy")}
        del ens, ep, ectx, etrace, second, steps

        # DCNet greedy.
        dcfg = get_named_config("dcnet_greedy").override(
            {"decode.batch_size": N_IMAGES,
             "model.vocab_size": cfg.model.vocab_size})
        dmodel = get_model(dcfg.model)
        dparams = load_params_npz(str(SMOKE_DIR / "params_dcnet.npz"), dev,
                                  arch="dcnet")
        dctx = dmodel.encode(dparams, None, existing, lens)
        dplain = greedy_decode(dmodel, dparams, dctx, **kw)
        dtrace = greedy_decode_with_attention(dmodel, dparams, dctx, **kw)
        for f in dplain._fields:
            check(torch.equal(getattr(dplain, f),
                              getattr(dtrace.rollout, f)),
                  f"DCNet greedy trace {f} differs from greedy_decode's")
        check(set(dtrace.attention) == {"alpha"},
              f"DCNet trace keys {sorted(dtrace.attention)}")
        out["dcnet_greedy"] = {"sum_err": _check_trace(dtrace, dctx.mask,
                                                       "dcnet greedy")}

        # captions/s, in turns.
        out["captions_per_s"] = {
            "editnet_greedy": _turns({
                "greedy_decode": lambda: greedy_decode(model, params, ctx,
                                                       **kw),
                "traced": lambda: greedy_decode_with_attention(
                    model, params, ctx, **kw)}),
            "editnet_beam5": _turns({
                "kernel_beam_search": lambda: beam_search(
                    model, params, ctx, **bkw),
                "full_logits_beam_search": lambda: beam_search(
                    full, params, ctx, **bkw),
                "traced": lambda: beam_decode_with_attention(
                    model, params, ctx, **bkw)}),
            "dcnet_greedy": _turns({
                "greedy_decode": lambda: greedy_decode(dmodel, dparams,
                                                       dctx, **kw),
                "traced": lambda: greedy_decode_with_attention(
                    dmodel, dparams, dctx, **kw)})}
    result = {"phase": "introspect", "ok": True, "card": card,
              "configs": ["editnet_beam5", "dcnet_greedy"],
              "batch": N_IMAGES, "max_len": MAX_LEN, "beam": BEAM, **out}
    emit(result)
    return result


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
        phase = "cell_kernels"
        cellk = phase_cell_kernels(ed, dc)
        phase = "greedy"
        greedy = phase_greedy(ed, dc, WRAPPERS, card)
        phase = "wholestep"
        whole = phase_wholestep(ed, WRAPPERS, card)
        phase = "fp32"
        fp32 = phase_fp32(ed, dc, WRAPPERS, card)
        phase = "beam10"
        phase_beam10(ed, WRAPPERS, card)
        phase = "wide_head"
        wide = phase_wide_head(card)
        phase = "evaluate"
        phase_evaluate(ed, WRAPPERS, card)
        phase = "train"
        try:
            train = phase_train(WRAPPERS, card)
            phase = "scst"
            scst = phase_scst(WRAPPERS, card)
        finally:
            import shutil

            shutil.rmtree(SMOKE_DIR / "train", ignore_errors=True)
        phase = "ensemble"
        ens = phase_ensemble(ed, dc, WRAPPERS, card)
        phase = "convert"
        conv = phase_convert(WRAPPERS, card)
        phase = "introspect"
        phase_introspect(ed, WRAPPERS, card)
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
        "launches_train": train["launches"]["fused_head_topk"],
        "launches_scst": scst["launches"]["fused_head_topk"],
        "launches_per_batch": decode["head_launches"],
        "cuda_launches_per_call": head["cuda_launches_per_call"],
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
            "source": {"fused_head_topk_int8":
                       "captionkit_torch/csrc/head_int8.cu",
                       "head_sweep_topk":
                       "captionkit_torch/csrc/head_sweep.cu"}.get(
                           name, "captionkit_torch/csrc/head_topk.cu"),
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
    # The dispatch kernels' main-path launches: the greedy decodes whose
    # dispatch sites take them (EditNet: the Copy-LSTM and two attentions
    # a step; DCNet: the LSTM and the text attention); their ms, plain and
    # bound at the greedy step's shapes (attention: EditNet's visual).
    ged, gdc = (greedy[n]["launches_per_batch"]
                for n in ("editnet_greedy", "dcnet_greedy"))
    times = cellk["times"]
    checks = cellk["checks"]
    new = {
        "fused_lstm_cell": (
            "captionkit_torch/csrc/lstm.cu", "captionkit/ops/lstm.py:153",
            gdc["fused_lstm_cell"], times["fused_lstm_cell"],
            max(max(c["max_abs_err"] for c in checks["lstm"].values()),
                greedy["dcnet_greedy"]["steps_check"]["max_abs_err"]
                ["get_lstm_cell_fn"])),
        "fused_copy_lstm_cell": (
            "captionkit_torch/csrc/lstm.cu", "captionkit/ops/lstm.py:153",
            ged["fused_copy_lstm_cell"], times["fused_copy_lstm_cell"],
            max(max(c["max_abs_err"] for c in checks["copy_lstm"].values()),
                greedy["editnet_greedy"]["steps_check"]["max_abs_err"]
                ["get_copy_lstm_cell_fn"])),
        "fused_additive_attention": (
            "captionkit_torch/csrc/attention.cu",
            "captionkit/ops/attention.py:125",
            ged["fused_additive_attention"]
            + gdc["fused_additive_attention"],
            times["fused_additive_attention/visual"],
            max(max(c["max_abs_err"] for c in checks["attention"].values()),
                *(greedy[n]["steps_check"]["max_abs_err"]
                  ["get_attention_fn"] for n in ("editnet_greedy",
                                                 "dcnet_greedy")))),
        "fused_lang_head_topk": (
            "captionkit_torch/csrc/wholestep.cu",
            "captionkit/ops/wholestep.py:184",
            whole["serve_launches"]["fused_lang_head_topk"],
            whole["kernel"],
            max(whole["kernel"]["max_abs_err"],
                whole["steps_check"]["vals_max_abs_err"],
                whole["steps_check"]["lse_max_abs_err"])),
    }
    per_batch = {"fused_lstm_cell": gdc["fused_lstm_cell"],
                 "fused_copy_lstm_cell": ged["fused_copy_lstm_cell"],
                 "fused_additive_attention":
                     ged["fused_additive_attention"]
                     + gdc["fused_additive_attention"],
                 "fused_lang_head_topk":
                     whole["launches_per_batch"]["fused_lang_head_topk"]}
    for name, (source, replaces_at, launches, res, err) in new.items():
        check(launches > 0, f"kernel {name} was not launched on its path")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces_at,
            "launches": launches,
            "launches_per_batch": per_batch[name],
            "cuda_launches_per_call": res["cuda_launches_per_call"],
            "check": "ok",
            "max_abs_err": err,
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
        })
    # The wide bf16 instances of the tiled heads (h streamed, H' = 2048):
    # launches from the two-member ensemble's server (mask) and its thresh
    # decode; held in wide_head at H = 2048 and 4096 and, mask, on the
    # ensemble decode's own states.
    for name, launches, per_batch_n, steps_err in (
            ("fused_head_topk", ens["serve_launches"]["fused_head_topk"],
             ens["launches_per_batch"]["fused_head_topk"],
             max(ens["steps_check"]["vals_max_abs_err"],
                 ens["steps_check"]["lse_max_abs_err"])),
            ("fused_head_topk_thresh",
             ens["variants"]["thresh"]["launches_per_batch"][
                 "fused_head_topk_thresh"],
             ens["variants"]["thresh"]["launches_per_batch"][
                 "fused_head_topk_thresh"], 0.0)):
        res = wide["kernels"][f"{name}/H=2048"]
        check(launches > 0, f"wide {name} was not launched on its path")
        kernels.append({
            "name": f"{name}[H=2048]",
            "route": "cuda",
            "source": "captionkit_torch/csrc/head_topk.cu",
            "replaces": "captionkit/ops/head.py:490",
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
    # The fp32 instances (compute_dtype="float32"), each with its launches
    # a batch on the fp32 path that runs it.
    sources = {e["name"]: (e["source"], e["replaces"]) for e in kernels}
    fp32_paths = {
        "fused_head_topk": "editnet_beam5_pallas",
        "fused_head_topk_thresh": "editnet_beam5_thresh",
        "head_sweep_topk": "editnet_beam5_sweep",
        "att_cell": "editnet_beam5_pallas", "lang_cell":
        "editnet_beam5_pallas", "dcnet_score": "dcnet_beam5_pallas",
        "dcnet_cell": "dcnet_beam5_pallas",
        "fused_lang_head_topk": "editnet_beam5_wholestep",
        "fused_lstm_cell": "dcnet_greedy",
        "fused_copy_lstm_cell": "editnet_greedy",
        "fused_additive_attention": "editnet_greedy"}
    for name, res in fp32["kernels"].items():
        launches = fp32["paths"][fp32_paths[name]]["launches_per_batch"][name]
        check(launches > 0, f"fp32 kernel {name} was not launched on its "
                            "path")
        kernels.append({
            "name": f"{name}[fp32]",
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches,
            "launches_per_batch": launches,
            "cuda_launches_per_call": res["cuda_launches_per_call"],
            "check": "ok",
            "max_abs_err": res["max_abs_err"],
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
        })
    # The parity gate's beam (fp32) runs the fp32 head instance.
    gate_entry = next(e for e in kernels
                      if e["name"] == "fused_head_topk[fp32]")
    gate_entry["launches_parity_gate"] = conv["launches"]["fused_head_topk"]
    emit({"kernels": kernels})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profile-train"]:
        sys.path.insert(0, str(ROOT))
        profile_train(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--profile-scst"]:
        sys.path.insert(0, str(ROOT))
        profile_scst(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
