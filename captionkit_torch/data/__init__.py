"""Input pipeline: vocabulary, tokenization, static-shape batching, split
loading (reference artifacts, the native feature store, offline
preparation in ``data.prepare``), the synthetic source and the
host->device feature feed."""

from captionkit_torch.data.vocab import (  # noqa: F401
    PAD, START, END, UNK,
    PAD_TOKEN, START_TOKEN, END_TOKEN, UNK_TOKEN,
    Vocab,
)
from captionkit_torch.data.tokenize import (  # noqa: F401
    ptb_tokenize,
    simple_tokenize,
)
from captionkit_torch.data.pipeline import (  # noqa: F401
    Batch,
    encode_captions,
    make_batches,
    pad_to,
)
from captionkit_torch.data.sources import (  # noqa: F401
    CaptionDataset,
    SyntheticCaptionSource,
    load_hdf5_features,
)
