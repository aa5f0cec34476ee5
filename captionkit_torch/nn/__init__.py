"""Numerics shared by the models: cells, attention, SCMA, masking, top-k."""

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
)
from captionkit_torch.nn.masking import NEG_INF, length_mask  # noqa: F401
from captionkit_torch.nn.topk import topk_lowest_index  # noqa: F401
