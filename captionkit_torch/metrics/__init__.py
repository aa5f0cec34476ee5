"""Caption metrics (copies of ``captionkit.metrics``), host-side Python:
BLEU-1..4, ROUGE-L, CIDEr and CIDEr-D with pycocoevalcap's algorithms,
METEOR-lite, the optional METEOR/SPICE jar adapters, the evaluator, and
the native CIDEr-D scorer (``metrics.fast``, C++ built at first use)."""

from captionkit_torch.metrics.bleu import bleu_scores  # noqa: F401
from captionkit_torch.metrics.cider import Cider, CiderD, NgramDocFreq  # noqa: F401
from captionkit_torch.metrics.eval import CaptionEvaluator, evaluate_captions  # noqa: F401
from captionkit_torch.metrics.meteor import meteor_lite, meteor_lite_score  # noqa: F401
from captionkit_torch.metrics.rouge import rouge_l  # noqa: F401
