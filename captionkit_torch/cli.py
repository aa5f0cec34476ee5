"""captionkit_torch CLI (``captionkit.cli``, the serving slice).

    python -m captionkit_torch.cli configs
    python -m captionkit_torch.cli serve --config editnet_beam5 --synthetic \\
        --batch 512 --ladder 1,8 --flush-ms 20
    python -m captionkit_torch.cli serve --config editnet_beam5 \\
        --wordmap WORDMAP.json --params params.npz --batch 512
    python -m captionkit_torch.cli serve --config dcnet_beam5 --synthetic \\
        --set model.cell_impl=pallas
    python -m captionkit_torch.cli serve --config editnet_beam5 --synthetic \\
        --set model.head_quant=int8 --set decode.feed_dtype=int8 \\
        [--set model.head_extract=thresh]

Both beam configs serve: ``editnet_beam5`` and ``dcnet_beam5`` (DCNet's
textual encoder reads the caption only; requests still carry features,
which it ignores, as in the reference). ``--set model.cell_impl=pallas``
runs the fused decode-cell kernels (``kernels/megastep.py``) in place of
the plain cells. ``--set model.head_quant=int8`` runs the int8 vocab-head
kernel, ``--set decode.feed_dtype=int8`` ships the features to the card
quantized per region (dequantized there), and ``--set
model.head_extract=thresh`` picks the heads' read-only top-k extraction
(the same captions). ``--params`` takes the flat ``.npz`` that either
package's ``save_params_npz`` writes, for the config's arch; without it
the weights are random from ``--seed``. ``--device`` defaults to ``cuda``
and raises when there is no card; ``--device cpu`` runs the plain versions
of the kernels on the CPU. The reference's other subcommands (greedy
decoding among them), ``--stacked``, checkpoint ensembles and
``cell_impl="wholestep"`` are not yet ported.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from captionkit_torch.config import (
    CaptionKitConfig,
    get_named_config,
    list_named_configs,
)

NOT_PORTED = ("decode", "decode-stacked", "train-xe", "train-scst",
              "convert", "parity-gate", "prepare")


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def _apply_overrides(cfg: CaptionKitConfig,
                     sets: list[str]) -> CaptionKitConfig:
    overrides = {}
    for s in sets:
        key, _, val = s.partition("=")
        if not val:
            raise SystemExit(f"--set expects section.field=value, got {s!r}")
        overrides[key] = _parse_value(val)
    return cfg.override(overrides)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("captionkit_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("configs", help="list named configs")
    sp = sub.add_parser(
        "serve", help="JSON-lines caption-edit server on stdin/stdout")
    sp.add_argument("--config", default="editnet_beam5")
    sp.add_argument("--set", action="append", default=[], metavar="K=V")
    sp.add_argument("--params", help="params .npz (else random weights)")
    sp.add_argument("--wordmap", help="WORDMAP json (reference format)")
    sp.add_argument("--synthetic", action="store_true",
                    help="toy vocab + random weights (demo/tests)")
    sp.add_argument("--batch", type=int, default=8,
                    help="largest micro-batch")
    sp.add_argument("--ladder", default="",
                    help="comma-separated smaller batch rungs, e.g. '1,8'")
    sp.add_argument("--flush-ms", dest="flush_ms", type=float, default=0,
                    help="longest wait of a queued request for its batch "
                         "to fill (0 = drain only on flush or EOF)")
    sp.add_argument("--warmup", action="store_true",
                    help="run every ladder rung once before reading")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    for name in NOT_PORTED:
        sub.add_parser(name, help="not yet ported")
    return p


def cmd_configs(args) -> int:
    for name in list_named_configs():
        cfg = get_named_config(name)
        print(f"{name:16s} arch={cfg.model.arch:8s} "
              f"decode={cfg.decode.method}/{cfg.decode.beam_size}")
    return 0


def cmd_serve(args) -> int:
    from captionkit_torch.data import SyntheticCaptionSource, Vocab
    from captionkit_torch.device import resolve_device
    from captionkit_torch.models import get_model
    from captionkit_torch.params import load_params_npz
    from captionkit_torch.serve import CaptionServer, serve_stream

    if not args.synthetic and not args.wordmap:
        raise SystemExit("serve: --wordmap is required without --synthetic")
    device = resolve_device(args.device)
    cfg = _apply_overrides(get_named_config(args.config), args.set)
    cfg = cfg.override({"decode.batch_size": args.batch})
    if args.synthetic:
        vocab = SyntheticCaptionSource(
            num_images=2, captions_per_image=1,
            num_regions=cfg.model.num_regions, feat_dim=cfg.model.feat_dim,
            max_len=cfg.data.max_existing_len, seed=0).vocab
    else:
        vocab = Vocab.load(args.wordmap)
    cfg = cfg.override({"model.vocab_size": len(vocab)})
    model = get_model(cfg.model)
    if args.params:
        if "," in args.params.strip(","):
            raise SystemExit("serve: checkpoint ensembles are not yet "
                             "ported; pass one --params file")
        params = load_params_npz(args.params.strip(","), device,
                                 arch=cfg.model.arch)
    else:
        params = model.init(args.seed, device)
    ladder = [int(s) for s in args.ladder.split(",")] if args.ladder else ()
    server = CaptionServer(cfg, params, model, vocab, ladder=ladder,
                           device=device)
    if args.warmup:
        server.warmup()
    serve_stream(server, sys.stdin, sys.stdout,
                 flush_ms=args.flush_ms or None)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in NOT_PORTED:
        raise SystemExit(f"captionkit_torch: '{args.cmd}' is not yet ported "
                         "(use captionkit.cli)")
    return {"configs": cmd_configs, "serve": cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
