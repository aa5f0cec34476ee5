#!/usr/bin/env python3
"""Greedy captions/s of EditNet and DCNet at paper width, each checkout in
processes of its own, in the order given:

    python3 examples/torch_greedy_processes.py DIR [DIR ...] [--rounds 8]

Each process imports the port from its DIR, makes random weights from seed
0 (`editnet_greedy`, `dcnet_greedy`) and 512 rows of random existing
captions (and region features for EditNet), then runs the 22-step greedy
decode with the end id disabled: 3 warm-up calls, then ``--rounds`` timed
calls (host clock, the card synchronized). Prints one JSON line a process
(each model's median and every call's captions/s), then one line of every
checkout's medians. The spread between processes of one checkout is what
a difference between two checkouts must exceed. Needs the card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROWS, STEPS = 512, 22


def one(checkout: str, rounds: int) -> dict:
    """Time both greedy decodes with the port of ``checkout``."""
    sys.path.insert(0, checkout)
    import torch

    from captionkit_torch.config import get_named_config
    from captionkit_torch.decode import greedy_decode
    from captionkit_torch.models import get_model

    gen = torch.Generator().manual_seed(0)
    out = {"checkout": checkout}
    for name in ("dcnet_greedy", "editnet_greedy"):
        cfg = get_named_config(name)
        model = get_model(cfg.model)
        params = model.init(0, "cuda")
        V = cfg.model.vocab_size
        existing = torch.randint(4, V, (ROWS, STEPS), generator=gen).cuda()
        lens = torch.randint(1, STEPS + 1, (ROWS,), generator=gen).cuda()
        feats = None if cfg.model.arch == "dcnet" else torch.randn(
            ROWS, cfg.model.num_regions, cfg.model.feat_dim,
            generator=gen).cuda()
        ctx = model.encode(params, feats, existing, lens)
        kw = dict(start_id=1, end_id=-1, max_len=STEPS)
        for _ in range(3):
            greedy_decode(model, params, ctx, **kw)
        torch.cuda.synchronize()
        runs = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            greedy_decode(model, params, ctx, **kw)
            torch.cuda.synchronize()
            runs.append(ROWS / (time.perf_counter() - t0))
        out[name] = {"captions_per_s": statistics.median(runs),
                     "runs": runs}
        del model, params, ctx
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.checkouts[0], args.rounds)), flush=True)
        return 0
    medians: dict = {}
    for checkout in args.checkouts:
        path = str(Path(checkout).resolve())
        proc = subprocess.run(
            [sys.executable, __file__, path, "--one", "--rounds",
             str(args.rounds)], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{checkout}: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        for name in ("dcnet_greedy", "editnet_greedy"):
            medians.setdefault(checkout, {}).setdefault(name, []).append(
                res[name]["captions_per_s"])
    print(json.dumps({"medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
