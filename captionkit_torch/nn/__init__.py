"""Numerics shared by the models: cells, attention, SCMA, masking, top-k,
and the dispatch between the plain cells and the cell kernels."""

from captionkit_torch.nn.attention import (  # noqa: F401
    AdditiveAttentionParams,
    additive_attention,
    project_keys,
    scma_select,
)
from captionkit_torch.nn.cells import (  # noqa: F401
    CopyLSTMParams,
    LSTMParams,
    copy_lstm_cell,
    lstm_cell,
    lstm_encode,
    lstm_gates,
    matmul_route,
    mm,
    pack_copy_lstm,
    pack_lstm,
)
from captionkit_torch.nn.dispatch import (  # noqa: F401
    get_attention_fn,
    get_copy_lstm_cell_fn,
    get_lstm_cell_fn,
)
from captionkit_torch.nn.masking import NEG_INF, length_mask  # noqa: F401
from captionkit_torch.nn.topk import topk_lowest_index  # noqa: F401
