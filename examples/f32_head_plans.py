#!/usr/bin/env python3
"""The fp32 heads of ``csrc/head_sm90.cuh`` at every cluster size, on the
card.

    python3 examples/f32_head_plans.py [--out FILE]

At the paper shape (N = 2560 rows, H = 1024, V = 9490 padded to 9600, k =
5, fp32 h and W), prints one JSON line: the card, the fp32 kernels'
cluster tables (clusters of 1 .. 8 CTAs the card holds at once), the plan
``sweep_plan`` takes, and for the sweep, mask and thresh kernels the ms a
call (CUDA events over 10 calls) at every share count the card can hold,
each result checked against the plain version (``F32_ATOL``, idx
agreement >= 0.999). Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    from captionkit_torch.kernels import head as thead

    cs.check(torch.cuda.is_available(), "needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    N, H, V, k = 2560, 1024, 9490, 5
    h = torch.randn((N, H), generator=g).to(dev)
    w = (torch.randn((H, V), generator=g) * 0.03).to(dev)
    b = (torch.randn((V,), generator=g) * 0.01).to(dev)
    w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.float32)
    Vp = w_p.shape[1]
    want = thead.reference_head_topk(h, w_p, b_p, k)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": cs.nvidia_smi_line(), "N": N, "H": H, "V": V, "k": k,
           "tables": {}, "plans": {}, "ms_by_shares": {}}
    kernels = {"sweep": ("head_sweep", "ck_head_sweep_f32", ()),
               "mask": ("head_topk", "ck_head_topk_f32", (0,)),
               "thresh": ("head_topk", "ck_head_topk_f32", (1,))}
    for name, (lib_name, entry, extract) in kernels.items():
        lib = thead._library(lib_name)
        table = thead.cluster_table(lib_name, dev, fp32=True)
        out["tables"][lib_name] = list(table)
        out["plans"][name] = thead.head_plan(lib_name, h, Vp)
        times = {}
        for shares in range(1, len(table)):
            if table[shares] < 1:
                continue
            vals, idx, lse = thead._outputs(N, k, dev)

            def call(shares=shares):
                tail = (*extract, shares, 0) if extract else (shares,)
                err = getattr(lib, entry)(
                    h.data_ptr(), w_p.data_ptr(), b_p.data_ptr(),
                    vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), N, H, Vp,
                    k, *tail, 0, stream)
                cs.check(err == 0, f"{entry} at {shares} shares: {err}")

            call()
            torch.cuda.synchronize()
            agree = cs.f32_agreement((vals, idx, lse), want)
            cs.check(agree["ok"], f"{name} at {shares} shares: {agree}")
            times[shares] = cs.time_ms(call, iters=10)
        out["ms_by_shares"][name] = times
    line = json.dumps(out)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
