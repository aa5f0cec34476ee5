"""COCOEvalCap-style driver (a copy of ``captionkit.metrics.eval``):
tokenize references and hypotheses once (``data.tokenize.ptb_tokenize``),
run every scorer, return one metrics dict. Host work only.

METEOR and SPICE are added only when their Java jars and a JVM are found
(``metrics.external``); without them the evaluator reports METEOR-lite
(``metrics.meteor``) when nltk is importable, and otherwise leaves it out
with a warning.
"""

from __future__ import annotations

import logging
from collections.abc import Mapping, Sequence
from typing import Optional

from captionkit_torch.data.tokenize import ptb_tokenize
from captionkit_torch.metrics.bleu import bleu_scores
from captionkit_torch.metrics.cider import Cider, CiderD, NgramDocFreq
from captionkit_torch.metrics.rouge import rouge_l

log = logging.getLogger(__name__)


class CaptionEvaluator:
    """evaluate({image_id: [ref strings]}, {image_id: hyp string}) -> dict.

    The 'CIDEr' key carries CIDEr-D semantics (count clipping + Gaussian
    length penalty): that is what cococaption reports under the name
    'CIDEr'. The unclipped variant is 'CIDEr-unclipped' with
    ``with_unclipped_cider``.
    """

    def __init__(
        self,
        *,
        df: Optional[NgramDocFreq] = None,
        with_unclipped_cider: bool = False,
        use_external: bool = True,
    ):
        self.cider = CiderD(df)
        self.cider_unclipped = Cider(df) if with_unclipped_cider else None
        self.use_external = use_external

    def evaluate(
        self,
        references: Mapping[object, Sequence[str]],
        hypotheses: Mapping[object, str],
    ) -> dict[str, float]:
        ids = sorted(hypotheses.keys(), key=str)
        missing = [i for i in ids if i not in references]
        if missing:
            raise KeyError(f"no references for image ids {missing[:5]}")
        hyp_tok = [ptb_tokenize(hypotheses[i]) for i in ids]
        ref_tok = [[ptb_tokenize(r) for r in references[i]] for i in ids]

        out: dict[str, float] = {}
        for n, b in enumerate(bleu_scores(hyp_tok, ref_tok), start=1):
            out[f"BLEU-{n}"] = b
        out["ROUGE-L"] = rouge_l(hyp_tok, ref_tok)
        out["CIDEr"], _ = self.cider.compute(hyp_tok, ref_tok)
        if self.cider_unclipped is not None:
            out["CIDEr-unclipped"], _ = self.cider_unclipped.compute(
                hyp_tok, ref_tok)
        if self.use_external:
            from captionkit_torch.metrics import external

            for name, scorer in external.available_scorers().items():
                try:
                    out[name] = scorer(references, hypotheses)
                except Exception:  # the jar run failed: metric stays absent
                    log.warning("external scorer %s failed", name,
                                exc_info=True)
            if "METEOR" not in out:
                # No jar or JVM: the in-process approximation, under its
                # own key. Its stemmer needs nltk, which is not a
                # dependency: without it the metric is left out.
                try:
                    from captionkit_torch.metrics.meteor import meteor_lite

                    out["METEOR-lite"], _ = meteor_lite(hyp_tok, ref_tok)
                except Exception:
                    log.warning("METEOR-lite unavailable", exc_info=True)
        return out


def evaluate_captions(
    references: Mapping[object, Sequence[str]],
    hypotheses: Mapping[object, str],
    **kw,
) -> dict[str, float]:
    return CaptionEvaluator(**kw).evaluate(references, hypotheses)
