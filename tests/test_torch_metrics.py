"""The port's caption metrics (``captionkit_torch.metrics``) against
``captionkit.metrics`` on the same seeded token corpora, and its native
CIDEr-D scorer and host-library build.

The scorers are float64 Python in the reference's loop and iteration
order, so every score must be bit-equal (``==``). ``NativeCiderD`` sums in
C++ in another order: within 1e-9 per image of the Python ``CiderD`` and
of the reference's native scorer. The corpora hold empty hypotheses,
hypotheses equal to a reference, unequal numbers of references (1 to 5)
and repeated n-grams.
"""

import stat

import numpy as np
import pytest

from captionkit.metrics import bleu as jbleu
from captionkit.metrics import cider as jcider
from captionkit.metrics import eval as jeval
from captionkit.metrics import rouge as jrouge

from captionkit_torch.metrics import bleu, cider, eval as teval, rouge
from captionkit_torch.metrics.fast import NativeCiderD
from captionkit_torch.utils import nativebuild


def _corpus(seed, n_img=16, vocab=12):
    """(hyps, refs): token lists; image i's hypothesis is empty (i % 4 ==
    0), one of its references (1), repeated bigrams (2) or random (3)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]

    def sent(lo=1, hi=12):
        return [words[j] for j in rng.integers(0, vocab,
                                               int(rng.integers(lo, hi)))]

    hyps, refs = [], []
    for i in range(n_img):
        r = [sent() for _ in range(int(rng.integers(1, 6)))]
        kind = i % 4
        h = ([] if kind == 0 else list(r[-1]) if kind == 1
             else [words[1], words[2]] * int(rng.integers(1, 5)) if kind == 2
             else sent(1, 15))
        hyps.append(h)
        refs.append(r)
    return hyps, refs


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_bleu_and_rouge_bit_equal(seed):
    hyps, refs = _corpus(seed)
    assert bleu.bleu_scores(hyps, refs) == jbleu.bleu_scores(hyps, refs)
    assert rouge.rouge_l(hyps, refs) == jrouge.rouge_l(hyps, refs)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["Cider", "CiderD"])
def test_cider_bit_equal(seed, name, tmp_path):
    """Corpus and per-image scores, with the corpus df built from the refs
    and with a precomputed df from another corpus, and after an .npz round
    trip through each package's save and load."""
    hyps, refs = _corpus(seed)
    train = _corpus(seed + 100, n_img=40)[1]
    t_df = cider.NgramDocFreq.build(train)
    j_df = jcider.NgramDocFreq.build(train)
    assert t_df.df == j_df.df and t_df.corpus_size == j_df.corpus_size
    t_df.save(str(tmp_path / "t.npz"))
    j_df.save(str(tmp_path / "j.npz"))
    for t_arg, j_arg in ((None, None), (t_df, j_df),
                         (cider.NgramDocFreq.load(str(tmp_path / "j.npz")),
                          jcider.NgramDocFreq.load(str(tmp_path / "t.npz")))):
        ts, tper = getattr(cider, name)(t_arg).compute(hyps, refs)
        js, jper = getattr(jcider, name)(j_arg).compute(hyps, refs)
        assert ts == js
        assert np.array_equal(tper, jper)
    back = cider.NgramDocFreq.load(str(tmp_path / "t.npz"))
    assert back.df == t_df.df and back.max_n == t_df.max_n


@pytest.mark.parametrize("seed", SEEDS)
def test_meteor_lite_bit_equal(seed):
    pytest.importorskip("nltk")
    from captionkit.metrics.meteor import meteor_lite as j_meteor
    from captionkit_torch.metrics.meteor import meteor_lite

    hyps, refs = _corpus(seed)
    # Stems: words that nltk's Porter stemmer maps together.
    hyps[3] = ["dogs", "running", "w1", "parks"]
    refs[3] = [["dog", "runs", "in", "park"], ["w1", "running"]]
    assert meteor_lite(hyps, refs) == j_meteor(hyps, refs)


def _strings(seed):
    hyps, refs = _corpus(seed)
    hyps[1] = ["a", "dog,", "running", "in", "the", "park."]
    refs[1] = [["a", "dog", "runs", "in", "a", "park"], ["dogs", "running"]]
    h = {i: " ".join(t) for i, t in enumerate(hyps)}
    r = {i: [" ".join(t) for t in rs] for i, rs in enumerate(refs)}
    return r, h


@pytest.mark.parametrize("use_external", [False, True])
def test_evaluator_bit_equal(use_external):
    refs, hyps = _strings(4)
    kw = dict(use_external=use_external, with_unclipped_cider=True)
    got = teval.CaptionEvaluator(**kw).evaluate(refs, hyps)
    want = jeval.CaptionEvaluator(**kw).evaluate(refs, hyps)
    assert got == want
    assert {"BLEU-1", "BLEU-4", "ROUGE-L", "CIDEr",
            "CIDEr-unclipped"} <= set(got)
    assert ("METEOR-lite" in got) == (use_external and _has_nltk())
    assert teval.evaluate_captions(refs, hyps, use_external=False) == \
        jeval.evaluate_captions(refs, hyps, use_external=False)


def _has_nltk():
    try:
        import nltk  # noqa: F401
    except ImportError:
        return False
    return True


def test_hypotheses_shifted_by_one_image_lower_cider_d():
    """Each image's hypothesis is a corrupted copy of one of its
    references; moving every hypothesis to the next image (a mix-up of
    image ids) must score lower."""
    refs, _ = _strings(5)
    rng = np.random.default_rng(5)
    hyps = {}
    for i, rs in refs.items():
        toks = rs[0].split()
        if len(toks) > 2:
            toks[int(rng.integers(len(toks)))] = "w0"
        hyps[i] = " ".join(toks)
    ev = teval.CaptionEvaluator(use_external=False)
    right = ev.evaluate(refs, hyps)["CIDEr"]
    shifted = {i: hyps[(i + 1) % len(hyps)] for i in hyps}
    assert ev.evaluate(refs, shifted)["CIDEr"] < right - 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_native_cider_d_within_1e9(seed):
    from captionkit.metrics import fast as jfast

    hyps, refs = _corpus(seed)
    hyps[5] = ["zebra", "w1", "unicorn"]  # tokens absent from the df
    df = cider.NgramDocFreq.build(_corpus(seed + 100, n_img=40)[1])
    nat = NativeCiderD(df).score(hyps, refs)
    _, py = cider.CiderD(df).compute(hyps, refs)
    np.testing.assert_allclose(nat, py, rtol=0, atol=1e-9)
    j_df = jcider.NgramDocFreq(dict(df.df), df.corpus_size, df.max_n)
    ref_nat = jfast.NativeCiderD(j_df).score(hyps, refs)
    np.testing.assert_allclose(nat, ref_nat, rtol=0, atol=1e-9)
    assert float(np.abs(nat).max()) > 1.0  # the copies score high


def test_native_build_is_named_by_its_source_and_compiler(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(nativebuild, "BUILD_DIR", tmp_path)
    path = nativebuild.build("cider")
    assert path.parent == tmp_path and path.name.startswith("libcider-")
    _, version = nativebuild.compiler()
    assert path == nativebuild.library_path("cider", version)
    assert nativebuild.library_path("cider", version + " other") != path
    assert not list(tmp_path.glob("*.tmp"))


def test_failed_native_build_raises(monkeypatch, tmp_path, capfd):
    """A compiler that does not exist, and one that fails: both raise,
    nothing falls back to the Python scorer or the numpy gather, and no
    library is left behind."""
    from captionkit_torch.data.faststore import FeatureStore

    np.save(tmp_path / "f.npy", np.zeros((4, 2, 3), np.float32))
    df = cider.NgramDocFreq.build([[["a", "b"]]])
    monkeypatch.setattr(nativebuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nativebuild, "_loaded", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        NativeCiderD(df)
    with pytest.raises(RuntimeError, match="no-such-g"):
        FeatureStore(str(tmp_path / "f.npy"))
    fake = tmp_path / "fake-g++"
    fake.write_text('#!/bin/sh\nif [ "$1" = --version ]; then echo fake 1.0;'
                    ' exit 0; fi\necho "error: planted failure" >&2\n'
                    'exit 1\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="planted failure"):
        NativeCiderD(df)
    assert "planted failure" in capfd.readouterr().err
    assert not any((tmp_path / "build").glob("*"))
