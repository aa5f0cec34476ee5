"""Decoding: batched beam search and the split-decode driver."""

from captionkit_torch.decode.beam import BeamResult, beam_search  # noqa: F401
from captionkit_torch.decode.driver import (  # noqa: F401
    decode_split,
    make_decode_fn,
)
