"""Decoding: batched beam search, greedy and sampling rollouts, the
split-decode and split-scoring driver, and the decodes with attention
traces (``introspect``)."""

from captionkit_torch.decode.beam import BeamResult, beam_search  # noqa: F401
from captionkit_torch.decode.driver import (  # noqa: F401
    decode_split,
    evaluate_split,
    make_decode_fn,
)
from captionkit_torch.decode.greedy import (  # noqa: F401
    Rollout,
    greedy_decode,
    sample_decode,
)
from captionkit_torch.decode.introspect import (  # noqa: F401
    AttentionTrace,
    BeamAttentionTrace,
    attention_report,
    beam_decode_with_attention,
    greedy_decode_with_attention,
)
