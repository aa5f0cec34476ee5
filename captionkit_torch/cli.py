"""captionkit_torch CLI (``captionkit.cli``: serving, decoding and scoring
a split, stacked editing, data preparation, XE and SCST training).

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
    python -m captionkit_torch.cli serve --config editnet_greedy --synthetic
    python -m captionkit_torch.cli serve --config editnet_beam5 --synthetic \\
        --set model.cell_impl=wholestep
    python -m captionkit_torch.cli prepare --karpathy dataset_coco.json \\
        --out prep --existing train=aoanet_train.json \\
        --existing test=aoanet_test.json --features test=test_feats.npy
    python -m captionkit_torch.cli decode --config editnet_beam5 \\
        --prepared prep --split test --params params.npz --out results.json
    python -m captionkit_torch.cli train-xe --config xe_train \\
        --prepared prep --split train --val-split val --max-steps 100 \\
        --export-params params.npz [--resume] [--device cpu]
    python -m captionkit_torch.cli train-scst --config scst_train \\
        --prepared prep --split train --val-split val --params xe.npz \\
        --export-params scst.npz [--pipeline] [--device cpu]
    python -m captionkit_torch.cli decode --config editnet_beam5 \\
        --prepared prep --split test --params a.npz,b.npz \\
        [--ensemble-mode prob]
    python -m captionkit_torch.cli decode-stacked --config editnet_beam5 \\
        --prepared prep --split test --dcnet-params dc.npz \\
        --editnet-params ed.npz --out results.json
    python -m captionkit_torch.cli serve --config editnet_beam5 --synthetic \\
        --stacked [--dcnet-params dc.npz] [--params ed.npz]
    python -m captionkit_torch.cli convert --torch BEST.pth.tar \\
        --arch editnet --out params.npz [--fit-names]
    python -m captionkit_torch.cli parity-gate --config editnet_beam5 \\
        --prepared prep --split test --ckpt BEST.pth.tar \\
        --set model.compute_dtype=float32 [--max-images 64] [--device cpu]
    python -m captionkit_torch.cli decode --config editnet_beam5 \\
        --wordmap WORDMAP.json --captions TEST_CAPTIONS.json \\
        --caplens TEST_CAPLENS.json --existing TEST_EXISTING.json \\
        --existing-lens TEST_EXISTING_CAPLENS.json \\
        --features TEST_FEATURES.npy --params params.npz

Every named decode config serves and decodes: the beam configs
``editnet_beam5`` and ``dcnet_beam5`` and the greedy ones
``editnet_greedy`` and ``dcnet_greedy`` (``--set decode.method=sample``
samples; DCNet's textual encoder reads the caption only; requests still
carry features, which it ignores, as in the reference). ``--set
model.cell_impl=pallas`` runs the fused decode-cell kernels
(``kernels/megastep.py``) in place of the plain cells, ``--set
model.cell_impl=wholestep`` (EditNet beam, float head) the whole-step
kernel (``kernels/wholestep.py``). ``--set model.head_quant=int8`` runs
the int8 vocab-head kernel, ``--set decode.feed_dtype=int8`` ships the
features to the card quantized per region (dequantized there), and
``--set model.head_extract=thresh`` picks the heads' read-only top-k
extraction (the same captions); ``--set decode.beam_impl=backptr`` the
backpointer beam history (the same captions). ``--params`` takes the flat
``.npz`` that either package's ``save_params_npz`` writes, for the
config's arch; without it the weights are random from ``--seed``. For
``decode`` and ``serve`` a comma list of such files decodes their
checkpoint ensemble (``models/ensemble.py``), its members combined by
``--ensemble-mode`` (``logprob``, the default: the mean of the member
logits; ``prob``: the mean of their probabilities). ``serve --stacked``
serves the DCNet -> EditNet pipeline (``--dcnet-params`` for DCNet,
``--params`` for EditNet; either may be a list).

``decode-stacked`` decodes a split through the same pipeline: DCNet
greedy, then EditNet as ``decode`` configures it, with
``--dcnet-params`` and ``--editnet-params`` (each one file, a comma list
or absent: random weights).

``decode`` decodes a split (``--synthetic``, a ``prepare`` directory with
``--prepared``/``--split``, or the reference's raw artifacts) and, where
the split has references and ``--no-metrics`` is absent, scores it; it
prints the metrics (and decode stats) as JSON rounded to 4 places and
writes the results JSON keyed by the split's real image ids with
``--out``. ``--num-shards``/``--shard-index`` decode one strided shard.
``prepare`` is host work only and needs no card.

``train-xe`` trains with cross-entropy (``train/loop.py::
run_xe_training``) on ``--synthetic`` data, a ``--prepared`` split or the
raw artifacts, validating each epoch on the split's one-row-per-image view
(or on ``--val-split`` of the ``--prepared`` directory; ``--no-val``
skips it), checkpointing under ``train.checkpoint_dir`` (``--resume``
continues from its latest checkpoint), and writing the final raw or EMA
weights as a decode-ready ``.npz`` with ``--export-params`` /
``--export-ema``. ``--run-dir`` writes ``metrics.jsonl``. It prints the
report as JSON. ``train-scst`` fine-tunes with SCST (``train/loop.py::
run_scst_training``) from one ``--params`` checkpoint (the XE weights;
random weights without it), with the same data, validation, export and
run-log flags, ``--pipeline`` to enqueue each batch's rollout before the
previous batch's reward and update, and no ``--resume`` (as in the
reference). Both refuse ``--num-shards`` above 1 until data-parallel
training is ported.

``convert`` turns a PyTorch checkpoint (a state dict, a pickled module or
the released training dict) into the flat ``.npz`` (``convert/
torch_import.py``), by the module-name table (``--name-map`` JSON
overrides) or, with ``--fit-names``, by the layout fitted from the
shapes; it is host work and takes no ``--device``. ``parity-gate`` runs
``convert/gate.py``: convert, greedy-identical against the torch twin
(exact tokens need ``--set model.compute_dtype=float32``), greedy against
``--expected-captions``, beam CIDEr against ``--expected-cider``; it prints
the report as JSON and exits 1 when a check failed.

``--device`` defaults to ``cuda`` and raises when there is no card;
``--device cpu`` runs the plain versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from captionkit_torch.config import (
    CaptionKitConfig,
    ModelConfig,
    get_named_config,
    list_named_configs,
)


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

    def add_ensemble_mode(sp):
        sp.add_argument("--ensemble-mode", dest="ensemble_mode",
                        choices=("logprob", "prob"), default="logprob",
                        help="member combination of a comma list of "
                             "checkpoints: mean logits (default) or mean "
                             "probabilities")
    sp = sub.add_parser(
        "serve", help="JSON-lines caption-edit server on stdin/stdout")
    sp.add_argument("--config", default="editnet_beam5")
    sp.add_argument("--set", action="append", default=[], metavar="K=V")
    sp.add_argument("--params",
                    help="params .npz (else random weights); a comma list "
                         "serves their ensemble")
    add_ensemble_mode(sp)
    sp.add_argument("--wordmap", help="WORDMAP json (reference format)")
    sp.add_argument("--synthetic", action="store_true",
                    help="toy vocab + random weights (demo/tests)")
    sp.add_argument("--stacked", action="store_true",
                    help="serve the DCNet->EditNet stacked pipeline "
                         "(--params = EditNet, --dcnet-params = DCNet)")
    sp.add_argument("--dcnet-params", dest="dcnet_params",
                    help="DCNet params .npz for --stacked; a comma list "
                         "ensembles that stage")
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

    def add_common(sp, shards=True):
        """The config, the split (synthetic, prepared or raw) and the
        device: the flags ``decode``, the trainers and ``parity-gate``
        share (``parity-gate`` without the shard flags)."""
        sp.add_argument("--config", required=True,
                        help="named config (see `configs`)")
        sp.add_argument("--set", action="append", default=[],
                        metavar="K=V", help="dotted config override")
        sp.add_argument("--synthetic", action="store_true",
                        help="use the generated toy dataset")
        sp.add_argument("--images", type=int, default=64,
                        help="synthetic dataset size")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--prepared",
                        help="prepare output dir (carries the references)")
        sp.add_argument("--split", default="train",
                        help="split name inside --prepared")
        sp.add_argument("--wordmap"), sp.add_argument("--captions")
        sp.add_argument("--caplens"), sp.add_argument("--existing")
        sp.add_argument("--existing-lens", dest="existing_lens")
        sp.add_argument("--features", default="")
        sp.add_argument("--captions-per-image", dest="captions_per_image",
                        type=int, default=None,
                        help="GT captions per image in raw artifacts "
                             "(needed without --features to group "
                             "references by image)")
        if shards:
            sp.add_argument(
                "--num-shards", dest="num_shards", type=int, default=1,
                help="decode: split the eval set across processes; run one "
                     "per shard and concatenate the results JSONs")
            sp.add_argument("--shard-index", dest="shard_index", type=int,
                            default=0,
                            help="this process's shard (0-based)")
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

    sp = sub.add_parser("decode", help="decode + score a split")
    add_common(sp)
    sp.add_argument("--params",
                    help="params .npz (else random weights); a comma list "
                         "decodes their ensemble")
    add_ensemble_mode(sp)
    sp.add_argument("--out", help="results JSON path")
    sp.add_argument("--no-metrics", action="store_true")

    sp = sub.add_parser("decode-stacked",
                        help="DCNet->EditNet stacked editing of a split")
    add_common(sp)
    sp.add_argument("--dcnet-params", dest="dcnet_params",
                    help="DCNet params .npz; a comma list ensembles that "
                         "stage")
    sp.add_argument("--editnet-params", dest="editnet_params",
                    help="EditNet params .npz; a comma list ensembles "
                         "that stage")
    add_ensemble_mode(sp)
    sp.add_argument("--out", help="results JSON path")
    sp.add_argument("--no-metrics", action="store_true")

    sp = sub.add_parser(
        "prepare", help="Karpathy JSON + existing captions (+features) -> "
                        "prepared artifacts dir")
    sp.add_argument("--karpathy", required=True,
                    help="Karpathy-split dataset JSON (dataset_coco.json)")
    sp.add_argument("--out", required=True, help="output artifact dir")
    sp.add_argument("--existing", action="append", required=True,
                    metavar="SPLIT=PATH",
                    help="existing-caption JSON per split (repeatable)")
    sp.add_argument("--features", action="append", default=[],
                    metavar="SPLIT=PATH",
                    help="[N,R,F] feature .npy per split")
    sp.add_argument("--min-word-freq", dest="min_word_freq", type=int,
                    default=5)
    sp.add_argument("--max-len", dest="max_len", type=int, default=22)
    sp.add_argument("--captions-per-image", dest="captions_per_image",
                    type=int, default=5)
    def add_train(sp):
        """The flags ``train-xe`` and ``train-scst`` share."""
        add_common(sp)
        sp.add_argument("--val-split", dest="val_split",
                        help="validate on this split of --prepared "
                             "(default: the training split's "
                             "one-row-per-image view)")
        sp.add_argument("--max-steps", dest="max_steps", type=int)
        sp.add_argument("--no-val", dest="no_val", action="store_true")
        sp.add_argument("--export-params", dest="export_params",
                        metavar="OUT.npz",
                        help="write the final raw weights as a "
                             "decode-ready .npz")
        sp.add_argument("--export-ema", dest="export_ema",
                        metavar="OUT.npz",
                        help="write the final EMA weights (needs "
                             "train.ema_decay > 0)")
        sp.add_argument("--run-dir", dest="run_dir", default="",
                        help="write metrics.jsonl there")

    sp = sub.add_parser("train-xe", help="cross-entropy training")
    add_train(sp)
    sp.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "train.checkpoint_dir")
    sp = sub.add_parser("train-scst", help="SCST fine-tuning")
    add_train(sp)
    sp.add_argument("--params",
                    help="the XE weights to fine-tune (one .npz; else "
                         "random weights)")
    sp.add_argument("--pipeline", action="store_true",
                    help="enqueue each batch's rollout before the previous "
                         "batch's reward and update (one-step-stale "
                         "policy)")

    sp = sub.add_parser("convert", help="torch checkpoint -> params .npz")
    sp.add_argument("--torch", required=True)
    sp.add_argument("--arch", required=True, choices=["dcnet", "editnet"])
    sp.add_argument("--out", required=True)
    sp.add_argument("--name-map", dest="name_map",
                    help="JSON overrides for the checkpoint module-name "
                         "table (see convert.torch_import.DEFAULT_NAME_MAPS)")
    sp.add_argument("--fit-names", dest="fit_names", action="store_true",
                    help="infer the checkpoint layout from parameter "
                         "shapes (convert.fit_names) instead of the name "
                         "map; dims come from --config (default: inferred "
                         "from the shapes)")
    sp.add_argument("--config", default="",
                    help="named config supplying model dims for --fit-names")
    sp.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="dotted config overrides for --fit-names dims, "
                         "e.g. model.hidden_dim=512")
    sp.add_argument("--fit-candidate", dest="fit_candidate", type=int,
                    default=0,
                    help="which ranked fit to convert (0 = best; see "
                         "--fit-report for the alternates)")
    sp.add_argument("--fit-report", dest="fit_report",
                    help="write the fitted translation + alternates + "
                         "notes as JSON here")

    sp = sub.add_parser(
        "parity-gate",
        help="torch ckpt -> convert -> greedy-identical -> beam CIDEr "
             "tolerance, in one command")
    add_common(sp, shards=False)
    sp.add_argument("--ckpt", required=True, help="torch checkpoint path")
    sp.add_argument("--name-map", dest="name_map",
                    help="JSON overrides for the checkpoint module-name "
                         "table")
    sp.add_argument("--expected-cider", dest="expected_cider", type=float,
                    help="published CIDEr to gate against (+/- tol)")
    sp.add_argument("--expected-captions", dest="expected_captions",
                    help="JSON {image_id: caption} of the original repo's "
                         "published greedy captions; gates exact string "
                         "match (catches semantics weights can't express, "
                         "e.g. soft-vs-hard SCMA)")
    sp.add_argument("--cider-tol", dest="cider_tol", type=float, default=0.2)
    sp.add_argument("--max-images", dest="max_images", type=int,
                    help="cap greedy-identical comparison size")
    sp.add_argument("--out", help="also write converted params .npz here")
    sp.add_argument("--fit-names", dest="fit_names", action="store_true",
                    help="infer the checkpoint layout from shapes and "
                         "sweep the ranked candidate fits through the "
                         "gate (decisive only with --expected-cider or "
                         "--expected-captions)")
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
    model, params = _load_stage_params(args, get_model(cfg.model),
                                       args.params, device)
    ladder = [int(s) for s in args.ladder.split(",")] if args.ladder else ()
    decode_fn = None
    if args.stacked:
        # DCNet edits the incoming caption greedily, then EditNet (the
        # configured decode) edits DCNet's output.
        import dataclasses

        from captionkit_torch.decode.stacked import make_stacked_decode_fn

        dcnet, dp = _load_stage_params(
            args, get_model(dataclasses.replace(cfg.model, arch="dcnet")),
            args.dcnet_params, device)
        stacked = make_stacked_decode_fn(
            dcnet, model,
            first_stage=dataclasses.replace(cfg.decode, method="greedy",
                                            beam_size=1),
            second_stage=cfg.decode, start_id=vocab.start,
            end_id=vocab.end, pad_id=vocab.pad,
            feed_dtype=cfg.decode.feed_dtype, device=device)
        params = (dp, params)

        def decode_fn(pair, feats, ids, lens, _step):
            return stacked(pair[0], pair[1], feats, ids, lens)

    server = CaptionServer(cfg, params, model, vocab, ladder=ladder,
                           decode_fn=decode_fn, device=device)
    if args.warmup:
        server.warmup()
    serve_stream(server, sys.stdin, sys.stdout,
                 flush_ms=args.flush_ms or None)
    return 0


def _load_stage_params(args, model, raw, device):
    """(model, params) of one ``--params``-style value: none, random
    weights from ``--seed``; one path, that checkpoint; a comma list, the
    checkpoint ensemble of ``model`` under ``--ensemble-mode``."""
    from captionkit_torch.params import load_params_npz

    paths = [p for p in (raw or "").split(",") if p]
    if len(paths) > 1:
        from captionkit_torch.models.ensemble import (
            ensemble_model,
            load_ensemble_params,
        )

        return (ensemble_model(model, len(paths),
                               mode=getattr(args, "ensemble_mode",
                                            "logprob")),
                load_ensemble_params(model, paths, device))
    if paths:
        return model, load_params_npz(paths[0], device, arch=model.name)
    return model, model.init(args.seed, device)


def _load_dataset(args, cfg):
    """(the split, its one-row-per-image view): ``--synthetic``, a
    ``--prepared`` split, or the raw reference artifacts."""
    from captionkit_torch.data import CaptionDataset, SyntheticCaptionSource

    if args.synthetic:
        src = SyntheticCaptionSource(
            num_images=args.images,
            captions_per_image=cfg.data.captions_per_image,
            num_regions=cfg.model.num_regions, feat_dim=cfg.model.feat_dim,
            max_len=cfg.data.max_len, seed=cfg.data.seed)
        return src.dataset, src.eval_view()
    if args.prepared:
        from captionkit_torch.data.prepare import load_prepared_split

        ds = load_prepared_split(args.prepared, args.split,
                                 max_len=cfg.data.max_len)
        return ds, ds.eval_view()
    ds = CaptionDataset.from_reference_files(
        wordmap_path=args.wordmap,
        captions_path=args.captions,
        caplens_path=args.caplens,
        existing_captions_path=args.existing,
        existing_caplens_path=args.existing_lens,
        features_path=args.features,
        max_len=cfg.data.max_len,
        captions_per_image=args.captions_per_image,
    )
    return ds, ds.eval_view()


def cmd_decode(args) -> int:
    from captionkit_torch.decode.driver import decode_split, evaluate_split
    from captionkit_torch.device import resolve_device
    from captionkit_torch.models import get_model

    device = resolve_device(args.device)
    cfg = _apply_overrides(get_named_config(args.config), args.set)
    _, eval_ds = _load_dataset(args, cfg)
    if args.num_shards > 1:
        eval_ds = eval_ds.shard(args.num_shards, args.shard_index)
    cfg = cfg.override({"model.vocab_size": len(eval_ds.vocab)})
    model, params = _load_stage_params(args, get_model(cfg.model),
                                       args.params, device)
    if eval_ds.references is not None and not args.no_metrics:
        metrics = evaluate_split(model, params, eval_ds, cfg.decode,
                                 results_path=args.out, device=device)
    else:
        _, metrics = decode_split(model, params, eval_ds, cfg.decode,
                                  results_path=args.out, device=device)
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()},
                     indent=2))
    return 0


def _load_train_datasets(args, cfg):
    """(train split, validation split): the validation split is one row
    per image, of ``--val-split`` when given, else of the training
    split."""
    ds, val = _load_dataset(args, cfg)
    if args.val_split:
        if not args.prepared:
            raise SystemExit(f"{args.cmd}: --val-split needs --prepared")
        from captionkit_torch.data.prepare import load_prepared_split

        val = load_prepared_split(args.prepared, args.val_split,
                                  max_len=cfg.data.max_len).eval_view()
    return ds, val


def _export_trained_params(args, state) -> None:
    """``--export-params`` / ``--export-ema``: decode-ready ``.npz``
    weights of the final state."""
    from captionkit_torch.params import save_params_npz
    from captionkit_torch.train.state import ema_params

    if args.export_params:
        save_params_npz(state.params, args.export_params)
    if args.export_ema:
        avg = ema_params(state)
        if avg is None:
            raise SystemExit(
                "--export-ema needs EMA tracking enabled: set "
                "--set train.ema_decay=0.999 (or similar) on this run")
        save_params_npz(avg, args.export_ema)


def _refuse_shards(args) -> None:
    if args.num_shards > 1:
        raise SystemExit(
            f"{args.cmd}: --num-shards > 1 needs data-parallel training, "
            "which is not ported yet; train on one card")


def _print_report(report, state) -> None:
    best = report.best_metric if report.best_metric > float("-inf") \
        else None
    print(json.dumps({
        "epochs_run": report.epochs_run,
        "best_val_cider": best,
        "preempted": report.preempted,
        "step": state.step,
        "history": report.history,
    }, indent=2, default=float))


def cmd_train_xe(args) -> int:
    import logging

    from captionkit_torch.device import resolve_device
    from captionkit_torch.models import get_model
    from captionkit_torch.train.checkpoint import CheckpointManager
    from captionkit_torch.train.loop import run_xe_training
    from captionkit_torch.train.state import create_train_state
    from captionkit_torch.utils.logging import MetricsLogger
    from captionkit_torch.utils.preemption import PreemptionGuard

    _refuse_shards(args)
    device = resolve_device(args.device)
    cfg = _apply_overrides(get_named_config(args.config), args.set)
    train_ds, val_ds = _load_train_datasets(args, cfg)
    cfg = cfg.override({"model.vocab_size": len(train_ds.vocab)})
    model = get_model(cfg.model)
    state = create_train_state(lambda seed: model.init(seed, device),
                               cfg.train)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                             keep=cfg.train.keep_checkpoints)
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        logging.getLogger("captionkit_torch.cli").info(
            "resumed from step %s", state.step)
    mlogger = MetricsLogger(args.run_dir) if args.run_dir else None
    with PreemptionGuard() as guard:
        state, report = run_xe_training(
            model, state, cfg, train_ds, None if args.no_val else val_ds,
            ckpt=ckpt, max_steps=args.max_steps, metrics_logger=mlogger,
            preemption=guard, device=device)
    if mlogger is not None:
        mlogger.close()
    _export_trained_params(args, state)
    _print_report(report, state)
    ckpt.close()
    return 0


def cmd_train_scst(args) -> int:
    from captionkit_torch.device import resolve_device
    from captionkit_torch.models import get_model
    from captionkit_torch.params import load_params_npz
    from captionkit_torch.train.checkpoint import CheckpointManager
    from captionkit_torch.train.loop import run_scst_training
    from captionkit_torch.train.state import create_train_state
    from captionkit_torch.utils.logging import MetricsLogger
    from captionkit_torch.utils.preemption import PreemptionGuard

    _refuse_shards(args)
    if args.params and "," in args.params:
        raise SystemExit(
            "train-scst takes one --params checkpoint (the XE weights to "
            "fine-tune); multi-checkpoint ensembles (--params a.npz,b.npz) "
            "are supported by `decode` and `serve` only")
    device = resolve_device(args.device)
    cfg = _apply_overrides(get_named_config(args.config), args.set)
    train_ds, val_ds = _load_train_datasets(args, cfg)
    cfg = cfg.override({"model.vocab_size": len(train_ds.vocab)})
    model = get_model(cfg.model)

    def init_params(seed):
        if args.params:
            return load_params_npz(args.params, device, arch=model.name)
        return model.init(seed, device)

    # The optimizer state (and the EMA, when on) starts from the loaded
    # weights.
    state = create_train_state(init_params, cfg.train)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                             keep=cfg.train.keep_checkpoints)
    mlogger = MetricsLogger(args.run_dir) if args.run_dir else None
    with PreemptionGuard() as guard:
        state, report = run_scst_training(
            model, state, cfg, train_ds, None if args.no_val else val_ds,
            ckpt=ckpt, max_steps=args.max_steps, metrics_logger=mlogger,
            pipeline=args.pipeline, preemption=guard, device=device)
    if mlogger is not None:
        mlogger.close()
    _export_trained_params(args, state)
    _print_report(report, state)
    ckpt.close()
    return 0


def cmd_decode_stacked(args) -> int:
    """DCNet -> EditNet stacked editing of a split: DCNet greedy, then
    EditNet as the config's decode says."""
    import dataclasses

    import numpy as np
    import torch

    from captionkit_torch.data.featquant import quantize_for_feed
    from captionkit_torch.decode.stacked import make_stacked_decode_fn
    from captionkit_torch.device import resolve_device
    from captionkit_torch.metrics.eval import CaptionEvaluator
    from captionkit_torch.models import get_model

    device = resolve_device(args.device)
    cfg = _apply_overrides(get_named_config(args.config), args.set)
    _, eval_ds = _load_dataset(args, cfg)
    if args.num_shards > 1:
        eval_ds = eval_ds.shard(args.num_shards, args.shard_index)
    vocab = eval_ds.vocab
    dcnet, dp = _load_stage_params(args, get_model(dataclasses.replace(
        cfg.model, arch="dcnet", vocab_size=len(vocab))),
        args.dcnet_params, device)
    editnet, ep = _load_stage_params(args, get_model(dataclasses.replace(
        cfg.model, arch="editnet", vocab_size=len(vocab))),
        args.editnet_params, device)
    fn = make_stacked_decode_fn(
        dcnet, editnet,
        first_stage=dataclasses.replace(cfg.decode, method="greedy",
                                        beam_size=1),
        second_stage=cfg.decode, start_id=vocab.start, end_id=vocab.end,
        pad_id=vocab.pad, feed_dtype=cfg.decode.feed_dtype, device=device)
    hyps = {}
    for batch in eval_ds.batches(cfg.decode.batch_size):
        toks = fn(dp, ep,
                  quantize_for_feed(batch.features, cfg.decode.feed_dtype),
                  torch.from_numpy(np.asarray(batch.existing, np.int64)),
                  torch.from_numpy(np.asarray(batch.existing_len,
                                              np.int64))).cpu().numpy()
        for row, valid, img in zip(toks, batch.valid, batch.image_id):
            if valid:
                hyps[int(img)] = vocab.decode_to_string(row)
    out = {"captions": len(hyps)}
    if eval_ds.references is not None and not args.no_metrics:
        refs = {i: [" ".join(t) for t in eval_ds.references[i]]
                for i in hyps}
        out.update(CaptionEvaluator().evaluate(refs, hyps))
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"image_id": k, "caption": v}
                       for k, v in sorted(hyps.items())], f)
    print(json.dumps({k: round(float(v), 4) for k, v in out.items()},
                     indent=2))
    return 0


def _parse_split_paths(pairs: list[str], flag: str) -> dict[str, str]:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"{flag} expects split=path, got {p!r}")
        split, path = p.split("=", 1)
        out[split] = path
    return out


def cmd_prepare(args) -> int:
    import dataclasses

    from captionkit_torch.data.prepare import prepare_from_karpathy

    out = prepare_from_karpathy(
        karpathy_json=args.karpathy,
        output_dir=args.out,
        existing_captions=_parse_split_paths(args.existing, "--existing"),
        features=(_parse_split_paths(args.features, "--features")
                  if args.features else None),
        min_word_freq=args.min_word_freq,
        max_len=args.max_len,
        captions_per_image=args.captions_per_image,
    )
    print(json.dumps(
        {split: dataclasses.asdict(ps) for split, ps in out.items()},
        indent=2))
    return 0


def _load_name_map(path):
    if not path:
        return None
    with open(path) as f:
        return json.load(f)


def cmd_convert(args) -> int:
    from captionkit_torch.convert.torch_import import (
        convert_torch_checkpoint,
    )

    if args.fit_names:
        import dataclasses

        from captionkit_torch.convert.fit_names import (
            fit_params_from_state_dict,
        )
        from captionkit_torch.convert.torch_import import (
            load_torch_state_dict,
        )
        from captionkit_torch.params import save_params_npz

        raw = load_torch_state_dict(args.torch)
        base = get_named_config(args.config) if args.config else None
        if base is not None:
            mcfg = _apply_overrides(base, args.set).model
        elif args.set:
            mcfg = _apply_overrides(
                get_named_config(
                    "editnet_beam5" if args.arch == "editnet"
                    else "dcnet_beam5"),
                args.set,
            ).model
        else:
            from captionkit_torch.convert.fit_names import (
                infer_dims,
                state_dict_shapes,
            )

            dims = infer_dims(state_dict_shapes(raw), args.arch)
            print(f"inferred dims: {dims}")
            mcfg = ModelConfig(arch=args.arch, **dims)
        if mcfg.arch != args.arch:
            mcfg = dataclasses.replace(mcfg, arch=args.arch)
        params, fit = fit_params_from_state_dict(
            raw, args.arch, mcfg, candidate=args.fit_candidate,
            device="cpu")
        save_params_npz(params, args.out)
        print(f"wrote {args.out} (fit candidate {args.fit_candidate} of "
              f"{len(fit.candidates)})")
        for n in fit.notes:
            print(f"  note: {n}")
        if fit.unmatched_raw:
            print(f"  WARNING: {len(fit.unmatched_raw)} checkpoint "
                  f"tensor(s) not matched (NOT converted): "
                  f"{fit.unmatched_raw[:8]}", file=sys.stderr)
        if args.fit_report:
            with open(args.fit_report, "w") as f:
                json.dump({"translation": fit.translation,
                           "alternates": fit.alternates,
                           "notes": fit.notes,
                           "unmatched_raw": fit.unmatched_raw}, f, indent=2)
            print(f"fit report: {args.fit_report}")
        return 0

    out = convert_torch_checkpoint(
        args.torch, args.arch, args.out,
        name_map=_load_name_map(args.name_map))
    print(f"wrote {out}")
    return 0


def cmd_parity_gate(args) -> int:
    """convert -> greedy-identical -> beam CIDEr, as one command."""
    from captionkit_torch.convert.gate import run_parity_gate
    from captionkit_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = _apply_overrides(get_named_config(args.config), args.set)
    _, eval_ds = _load_dataset(args, cfg)
    cfg = cfg.override({"model.vocab_size": len(eval_ds.vocab)})
    expected_captions = None
    if args.expected_captions:
        with open(args.expected_captions) as f:
            expected_captions = json.load(f)
    report = run_parity_gate(
        args.ckpt, cfg, eval_ds,
        name_map=_load_name_map(args.name_map),
        expected_cider=args.expected_cider,
        cider_tol=args.cider_tol,
        max_images=args.max_images,
        out_params_path=args.out,
        expected_captions=expected_captions,
        fit_names=args.fit_names,
        device=device,
    )
    print(json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"configs": cmd_configs, "serve": cmd_serve, "decode": cmd_decode,
            "decode-stacked": cmd_decode_stacked, "prepare": cmd_prepare,
            "train-xe": cmd_train_xe, "train-scst": cmd_train_scst,
            "convert": cmd_convert,
            "parity-gate": cmd_parity_gate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
