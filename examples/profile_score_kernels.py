#!/usr/bin/env python3
"""Per-launch device times of the dispatch attention (B6), DCNet's score
kernel and EditNet's att_cell on one card.

    python3 examples/profile_score_kernels.py [--cases PREFIX,...]
        [CHECKOUT ...]

For each checkout (default: this one), in a process of its own that
imports that checkout's ``captionkit_torch`` and builds its kernels, runs
``fused_additive_attention`` at the shapes of its paths, paper widths:
the greedy step's 512 rows (EditNet's visual attention, 36 regions x
2048, no mask; the masked 22 x 1024 class of the SCMA and DCNet's text
attention, caption lengths 8 to 22 as ``chip_smoke.py``'s batch has
them) and 2560 rows of the visual class; and ``dcnet_score`` at 2560 rows
(512 images x 5 beams, 22 caption positions); ``att_cell`` at 2560 rows
(the att-LSTM over E + 2H = 3072, the query product of both heads, then
the scores of the visual head, 36 x 512 with no mask, and of the SCMA
head, 22 x 512 at those caption lengths); each in bf16 and again in
fp32 (``compute_dtype=float32``: fp32 keys, values and weights, the
cases' names ending in ``_f32``). Inputs are random from seed 0. Each
case is measured with this repo's ``chip_smoke.py`` helpers: CUDA-event
ms a call (``time_ms``), each launch's device ms a call by kernel name
(``_profile_kernels``), their sum with and without the wrapper's own
PyTorch launches, and a call's device span from the port's first kernel
to its last (``_device_span_ms``), which counts once the time two
launches overlap; for ``dcnet_score`` and ``att_cell`` also each launch's
window in the call (``_launch_windows``) and the score stage's own device
ms and what it adds to the call after the query product
(``_stage_times``). Prints one JSON line per checkout with the card's name
and power limit. ``--cases``: only the cases whose names start with one
of the prefixes (e.g. ``att_cell,dcnet_score``). Needs the card; imports
nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# A call's first and last kernel: this tree's names, then the wmma-era
# names of earlier trees.
SCORES = ("score_kernel", "scores_kernel")
SPANS = {"fused_additive_attention": (("query_kernel", "gemm_kernel"),
                                      ("context_kernel", "attention_kernel")),
         "dcnet_score": (("cell_kernel", "gemm_kernel"), SCORES),
         "att_cell": (("cell_kernel<4,", "gemm_kernel<0,"), SCORES)}
# The launches of a call in order, by label: a name key of each (bf16,
# then fp32; sm90_cell.cuh's epilogues 4 the att-LSTM, 3 the query store;
# cell_common.cuh's 0 the LSTM, 3 the store).
STAGES = {"dcnet_score": {"query": ("cell_kernel<3,", "gemm_kernel<3,"),
                          "scores": SCORES},
          "att_cell": {"lstm": ("cell_kernel<4,", "gemm_kernel<0,"),
                       "query": ("cell_kernel<3,", "gemm_kernel<3,"),
                       "scores": SCORES}}


def _smoke():
    """This repo's chip_smoke.py as a module (not a checkout's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cases():
    import torch

    from captionkit_torch.kernels import attention as ka
    from captionkit_torch.kernels import megastep as ms
    from captionkit_torch.nn.attention import AdditiveAttentionParams

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda()

    H, A = 1024, 512
    att = AdditiveAttentionParams(
        w_enc=randn(8, A), w_q=randn(H, A, scale=H ** -0.5),
        v=randn(A, scale=A ** -0.5), b=randn(A, scale=0.1))
    lengths = torch.randint(8, 23, (512,), generator=g).cuda()
    mask = torch.arange(22, device="cuda")[None, :] < lengths[:, None]
    shapes = {"visual_512": (512, 36, 2048, None),
              "masked_512": (512, 22, 1024, mask),
              "visual_2560": (2560, 36, 2048, None)}
    N, B, T = 2560, 512, 22
    dmask = (torch.arange(T, device="cuda")[None, :]
             < lengths[:, None]).float()
    dcnet_wq = randn(H, A, scale=H ** -0.5)
    dcnet_v, dcnet_b = randn(A, scale=A ** -0.5), randn(A, scale=0.1)
    dcnet_keys = randn(B, T, A, scale=0.5)
    h = randn(N, H, scale=0.5)
    # att_cell at paper width: E = H = 1024, A = 512, R = 36, T = 22.
    R = 36
    att_w = randn(3 * H, 4 * H, scale=(3 * H) ** -0.5)
    att_wq = randn(H, 2 * A, scale=H ** -0.5)
    att_vecs = [randn(A, scale=s_) for s_ in (A ** -0.5, 0.1) * 2]
    vis_keys, scma_keys = (randn(B, P, A, scale=0.5) for P in (R, T))
    zvb = randn(N, 4 * H, scale=0.1)
    att_args = (randn(N, H, scale=0.1),
                *(randn(N, H, scale=0.5) for _ in range(3)))
    out = {}
    for suffix, dt in (("", bf), ("_f32", torch.float32)):
        wq = att.w_q.to(dt)
        for name, (B_, P, V, m) in shapes.items():
            keys = randn(B_, P, A, scale=0.5).to(dt)
            values = randn(B_, P, V).to(dt)
            q = randn(B_, H, scale=0.5)
            out[f"fused_additive_attention/{name}{suffix}"] = (
                lambda keys=keys, values=values, q=q, m=m, wq=wq, dt=dt:
                ka.fused_additive_attention(att, keys, values, q, m,
                                            w_q=wq, compute_dtype=dt))
        small = torch.zeros((128, 128), dtype=dt, device="cuda")
        pack = ms.DCNetCellPack(
            att_wq=dcnet_wq.to(dt), att_v=dcnet_v, att_b=dcnet_b,
            gate_w=small, gate_b=small[0].float(), dec_w=small,
            b=small[0].float(), att_keys=dcnet_keys.to(dt),
            enc_hs=small[None], mask=dmask)
        out[f"dcnet_score/2560{suffix}"] = (
            lambda pack=pack: ms.dcnet_score(pack, h))
        cpack = ms.CellPack(
            w_att=att_w.to(dt), wq=att_wq.to(dt), vis_v=att_vecs[0],
            vis_b=att_vecs[1], scma_v=att_vecs[2], scma_b=att_vecs[3],
            gate_w=small, gate_b=small[0].float(), lang_w=small,
            lang_b=small[0].float(),
            wr=torch.zeros((1, H), dtype=dt, device="cuda"),
            br=small[0].float(), vis_keys=vis_keys.to(dt),
            features=small[None], scma_keys=scma_keys.to(dt),
            enc_cs=small[None], scma_mask=dmask, zvb=zvb)
        out[f"att_cell/2560{suffix}"] = (
            lambda cpack=cpack: ms.att_cell(cpack, *att_args))
    return out


def child(checkout: Path, prefixes: tuple[str, ...]) -> None:
    import torch

    smoke = _smoke()
    res = {}
    for name, fn in cases().items():
        if not name.startswith(prefixes):
            continue
        by_launch = smoke._profile_kernels(fn, None, calls=20)
        kind = name.split("/")[0]
        pick = lambda keys: next(  # noqa: E731  this tree's name of a launch
            k for k in keys if any(k in n for n in by_launch))
        first, last = (pick(keys) for keys in SPANS[kind])
        res[name] = {
            "ms": smoke.time_ms(fn, iters=50, warm=5),
            "by_launch": {k[:100]: v for k, v in by_launch.items()},
            "device_ms": sum(ms for _, ms in by_launch.values()),
            "kernel_device_ms": sum(ms for k, (_, ms) in by_launch.items()
                                    if "at::native" not in k),
            "device_span_ms": smoke._device_span_ms(fn, first, last,
                                                    calls=20)}
        if kind in STAGES:
            labels = {label: pick(keys)
                      for label, keys in STAGES[kind].items()}
            windows = smoke._launch_windows(fn, labels, calls=20)
            res[name].update(windows=windows,
                             **smoke._stage_times(windows, "scores"))
    print(json.dumps({"checkout": str(checkout),
                      "card": smoke.nvidia_smi_line(),
                      "device": torch.cuda.get_device_name(0),
                      "cases": res}), flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        sys.path.insert(0, sys.argv[2])
        child(Path(sys.argv[2]), tuple(sys.argv[3].split(",")))
        return 0
    args = sys.argv[1:]
    prefixes = ""  # every case
    if args[:1] == ["--cases"]:
        prefixes, args = args[1], args[2:]
    checkouts = [Path(p).resolve() for p in args] or [HERE]
    for checkout in checkouts:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(checkout), prefixes],
            cwd=checkout, timeout=900)
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
