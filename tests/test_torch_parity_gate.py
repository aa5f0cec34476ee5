"""The port's parity gate (``captionkit_torch.convert.gate``) and its CLI
commands against ``captionkit.convert.gate`` and ``captionkit.cli`` on the
same torch-twin checkpoints and the same synthetic split, fp32 on the CPU.

The reports are equal key for key (every check's status, the mismatch
lists, ``beam_cider`` to the last digit: the metrics are bit-equal), apart
from the port's ``seconds`` (the wall time of each check, which the
reference does not report). ``cli convert`` writes the same ``.npz``;
``cli parity-gate --device cpu`` prints the same JSON.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from captionkit import cli as jax_cli
from captionkit.convert import gate as jgate
from captionkit.data.sources import SyntheticCaptionSource as JaxSource
from captionkit.utils.config import get_named_config as jax_named_config

from captionkit_torch import cli
from captionkit_torch.config import get_named_config
from captionkit_torch.convert import gate
from captionkit_torch.convert.torch_ref import TorchEditNet
from captionkit_torch.data import SyntheticCaptionSource

E, H, A, F, R = 12, 16, 8, 10, 4
SRC = dict(num_images=6, captions_per_image=2, num_regions=R, feat_dim=F,
           max_len=12, seed=3)
SETS = {"model.emb_dim": E, "model.hidden_dim": H, "model.att_dim": A,
        "model.feat_dim": F, "model.num_regions": R, "model.dropout": 0.0,
        "model.compute_dtype": "float32", "decode.max_decode_len": 12,
        "decode.batch_size": 8, "data.max_len": 12}


@pytest.fixture(scope="module")
def sources():
    jsrc, src = JaxSource(**SRC), SyntheticCaptionSource(**SRC)
    assert src.vocab.word2id == jsrc.vocab.word2id
    return jsrc, src


@pytest.fixture(scope="module")
def twin(sources):
    torch.manual_seed(0)
    return TorchEditNet(len(sources[1].vocab), E, H, A, F).eval()


def _cfgs(vocab_size, **model):
    over = dict(SETS, **{"model.vocab_size": vocab_size},
                **{f"model.{k}": v for k, v in model.items()})
    return (jax_named_config("editnet_beam5").override(over),
            get_named_config("editnet_beam5").override(over))


def _without_seconds(report):
    report = dict(report)
    assert set(report.pop("seconds")) >= {"convert"}
    return report


def _both(ckpt, sources, *, jax_ds=None, ds=None, model=None, **kw):
    """(the port's report without ``seconds``, the reference's)."""
    jsrc, src = sources
    jcfg, cfg = _cfgs(len(src.vocab), **(model or {}))
    want = jgate.run_parity_gate(str(ckpt), jcfg,
                                 jax_ds or jsrc.dataset, **kw)
    got = gate.run_parity_gate(str(ckpt), cfg, ds or src.dataset,
                               device="cpu", **kw)
    if "seconds" in got:
        got = _without_seconds(got)
    return got, want


def _published(twin, src, ids=None, max_len=12):
    """{image id: caption} of the twin's greedy decode (the "published"
    captions of the original code)."""
    ev = src.dataset.eval_view()
    seqs = gate._twin_greedy(
        twin, "editnet", np.asarray(ev.features, np.float32),
        np.asarray(ev.existing), np.asarray(ev.existing_len),
        start_id=src.vocab.start, end_id=src.vocab.end, max_len=max_len)
    keys = ids if ids is not None else [int(i) for i in ev.image_index]
    return {int(k): src.vocab.decode_to_string(s)
            for k, s in zip(keys, seqs)}


def test_gate_passes_as_the_reference(tmp_path, sources, twin):
    ckpt = tmp_path / "BEST_checkpoint.pth.tar"
    torch.save({"state_dict": twin.state_dict()}, ckpt)
    got, want = _both(ckpt, sources, max_images=4)
    assert got == want
    assert got["ok"] is True
    assert got["checks"]["greedy_identical"]["images"] == 4
    assert got["checks"]["beam_cider"]["status"] == "pass"


def test_gate_expected_cider_outside_tolerance(tmp_path, sources, twin):
    ckpt = tmp_path / "ckpt.pth"
    torch.save(twin.state_dict(), ckpt)
    got, want = _both(ckpt, sources, max_images=4, expected_cider=5.0,
                      cider_tol=0.2)
    assert got == want
    assert got["checks"]["beam_cider"]["status"] == "fail"
    assert got["ok"] is False


def _rename(sd, mapping, prefix=""):
    out = {}
    for k, v in sd.items():
        for old, new in mapping.items():
            if k.startswith(old + "."):
                k = new + k[len(old):]
                break
        out[prefix + k] = v
    return out


def test_gate_alternate_layout_skips_the_twin(tmp_path, sources, twin):
    alt = _rename(twin.state_dict(), {"f_beta": "beta_gate"},
                  prefix="decoder.")
    ckpt = tmp_path / "alt.pth"
    torch.save(alt, ckpt)
    got, want = _both(ckpt, sources, max_images=4, name_map={
        "__strip_prefix__": "decoder.", "vis_gate": "beta_gate"})
    # The twin's load error names the class: the reference's module path
    # against the port's.
    reason = got["checks"]["greedy_identical"].pop("reason")
    ref_reason = want["checks"]["greedy_identical"].pop("reason")
    assert reason.split(" for ")[0] == ref_reason.split(" for ")[0]
    assert got == want
    assert got["checks"]["greedy_identical"]["status"] == "skipped"
    assert got["ok"] is True


def test_gate_hard_scma_checkpoint(tmp_path, sources):
    src = sources[1]
    torch.manual_seed(3)
    hard_twin = TorchEditNet(len(src.vocab), E, H, A, F,
                             scma_mode="hard").eval()
    ckpt = tmp_path / "hard.pth"
    torch.save(hard_twin.state_dict(), ckpt)
    published = _published(hard_twin, src)
    got, want = _both(ckpt, sources, expected_captions=published)
    assert got == want
    assert got["checks"]["greedy_expected"]["status"] == "fail"
    got, want = _both(ckpt, sources, expected_captions=published,
                      model={"scma_select": "hard"})
    assert got == want
    assert got["checks"]["greedy_expected"]["status"] == "pass"
    assert got["checks"]["greedy_expected"]["compared"] == 6


def test_gate_expected_captions_keyed_by_real_ids(tmp_path, sources, twin):
    jsrc, src = sources
    ckpt = tmp_path / "ckpt.pth"
    torch.save(twin.state_dict(), ckpt)
    n_img = len(src.dataset.eval_view().image_index)
    coco = np.asarray([100000 + 7 * b for b in range(n_img)], np.int64)
    published = _published(twin, src, ids=coco)
    got, want = _both(
        ckpt, sources, max_images=4, expected_captions=published,
        jax_ds=dataclasses.replace(jsrc.dataset, image_ids=coco),
        ds=dataclasses.replace(src.dataset, image_ids=coco))
    assert got == want
    assert got["checks"]["greedy_expected"] == {
        "status": "pass", "compared": 4, "mismatches": []}


def _scramble(sd):
    mapping = {
        "vis_attention.encoder_att": "blk3.u0",
        "vis_attention.decoder_att": "blk3.u1",
        "vis_attention.full_att": "blk3.u2",
        "scma.encoder_att": "blk5.u0", "scma.decoder_att": "blk5.u1",
        "scma.full_att": "blk5.u2", "lang_lstm.base": "blk6.cell",
        "lang_lstm": "blk6", "embedding": "blk0", "encoder": "blk1",
        "att_lstm": "blk2", "f_beta": "blk4", "fc": "blk7",
    }
    out = {}
    for k, v in sd.items():
        nk = k
        for old, new in sorted(mapping.items(), key=lambda x: -len(x[0])):
            if nk == old or nk.startswith(old + "."):
                nk = new + nk[len(old):]
                break
        out[nk] = v
    return out


def test_gate_fit_names_sweep_decided_by_published(tmp_path, sources, twin):
    ckpt = tmp_path / "scrambled.pth"
    torch.save(_scramble(twin.state_dict()), ckpt)
    published = _published(twin, sources[1])
    got, want = _both(ckpt, sources, max_images=4, fit_names=True,
                      expected_captions=published,
                      out_params_path=str(tmp_path / "p.npz"))
    assert got == want
    assert got["ok"] is True and got["fit"]["of"] == 4
    assert "warning" not in got["fit"]


def test_gate_fit_names_fails_on_unmatched_tensors(tmp_path, sources, twin):
    sd = dict(_scramble(twin.state_dict()))
    sd["mystery.extra_weight"] = torch.zeros(7, 9)
    ckpt = tmp_path / "extra.pth"
    torch.save(sd, ckpt)
    out = tmp_path / "p.npz"
    got, want = _both(ckpt, sources, max_images=2, fit_names=True,
                      out_params_path=str(out))
    assert got == want
    assert got["ok"] is False
    assert got["checks"]["convert"]["status"] == "fail"
    assert not out.exists()


def _npz(path):
    with np.load(path) as z:
        return {n: z[n] for n in z.files}


def test_cli_convert_and_gate_match_the_reference_cli(tmp_path, capsys):
    src = SyntheticCaptionSource(num_images=6, captions_per_image=5,
                                 num_regions=R, feat_dim=F, max_len=12,
                                 seed=0)
    torch.manual_seed(0)
    twin = TorchEditNet(len(src.vocab), E, H, A, F).eval()
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"epoch": 2, "decoder": twin}, ckpt)
    scrambled = tmp_path / "scrambled.pth"
    torch.save(_scramble(twin.state_dict()), scrambled)
    dims = [a for k in ("emb_dim", "hidden_dim", "att_dim", "feat_dim",
                        "num_regions")
            for a in ("--set", f"model.{k}={SETS['model.' + k]}")]
    for tag, main in (("jax", jax_cli.main), ("torch", cli.main)):
        assert main(["convert", "--torch", str(ckpt), "--arch", "editnet",
                     "--out", str(tmp_path / f"{tag}.npz")]) == 0
        assert main(["convert", "--torch", str(scrambled), "--arch",
                     "editnet", "--out", str(tmp_path / f"{tag}_fit.npz"),
                     "--fit-names", "--fit-report",
                     str(tmp_path / f"{tag}_fit.json"), "--set",
                     f"model.vocab_size={len(src.vocab)}", *dims]) == 0
    capsys.readouterr()
    for name in ("", "_fit"):
        want, got = (_npz(tmp_path / f"{t}{name}.npz")
                     for t in ("jax", "torch"))
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert (json.loads((tmp_path / "torch_fit.json").read_text())
            == json.loads((tmp_path / "jax_fit.json").read_text()))

    argv = ["parity-gate", "--config", "editnet_beam5", "--synthetic",
            "--images", "6", "--seed", "0", "--ckpt", str(ckpt),
            "--max-images", "4",
            *[a for k, v in SETS.items() for a in ("--set", f"{k}={v}")]]
    reports = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        reports.append(json.loads(capsys.readouterr().out))
    assert _without_seconds(reports[1]) == reports[0]
    assert reports[0]["checks"]["greedy_identical"]["status"] == "pass"


def _prepared_split(tmp_path):
    """A prepared test split (6 images, 2 references each, features
    [6, R, F]) from a Karpathy-layout JSON, by the port's ``prepare``."""
    from captionkit_torch.data.prepare import prepare_from_karpathy

    rng = np.random.default_rng(0)
    words = "a man dog rides runs on the beach park horse".split()
    images, existing = [], {"train": [], "test": []}
    for i in range(10):
        split = "train" if i < 4 else "test"
        caps = [list(rng.choice(words, 6)) for _ in range(2)]
        images.append({"split": split, "cocoid": 500 + i,
                       "sentences": [{"tokens": c} for c in caps]})
        existing[split].append({"image_id": 500 + i,
                                "caption": " ".join(caps[0][1:])})
    (tmp_path / "k.json").write_text(json.dumps({"images": images}))
    epaths = {}
    for split, rows in existing.items():
        epaths[split] = str(tmp_path / f"existing_{split}.json")
        (tmp_path / f"existing_{split}.json").write_text(json.dumps(rows))
    np.save(tmp_path / "f.npy",
            rng.standard_normal((6, R, F)).astype(np.float32))
    prepare_from_karpathy(
        karpathy_json=str(tmp_path / "k.json"),
        output_dir=str(tmp_path / "prep"), existing_captions=epaths,
        features={"test": str(tmp_path / "f.npy")}, min_word_freq=1,
        max_len=12, captions_per_image=2)
    return tmp_path / "prep"


def test_gate_reads_a_prepared_split(tmp_path):
    """A prepared split's features are a ``FeatureStore``, which gathers
    index arrays: the port's gate takes the greedy images' features by
    their image indices and passes. The reference slices
    ``features[:n]`` there and raises (a reference fault, not repaired in
    the JAX package)."""
    from captionkit.data.prepare import load_prepared_split as j_load

    from captionkit_torch.data.prepare import load_prepared_split

    prep = _prepared_split(tmp_path)
    ds = load_prepared_split(str(prep), "test", max_len=12)
    torch.manual_seed(0)
    twin = TorchEditNet(len(ds.vocab), E, H, A, F).eval()
    ckpt = tmp_path / "ckpt.pth"
    torch.save(twin.state_dict(), ckpt)
    jcfg, cfg = _cfgs(len(ds.vocab))
    rep = gate.run_parity_gate(str(ckpt), cfg, ds, max_images=4,
                               device="cpu")
    assert rep["ok"] is True, rep
    assert rep["checks"]["greedy_identical"]["images"] == 4
    with pytest.raises(TypeError):
        jgate.run_parity_gate(str(ckpt), jcfg,
                              j_load(str(prep), "test", max_len=12),
                              max_images=4)
