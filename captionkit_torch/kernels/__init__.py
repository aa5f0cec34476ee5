"""Hand-written CUDA kernels of the port, their build and their wrappers.

Every wrapper sits beside a plain PyTorch version of the same function in
the same module. A wrapper uses the plain version only for tensors on the
CPU; on a CUDA tensor it launches its kernel or raises. Each wrapper counts
its launches in a plain integer attribute (``<wrapper>.launches``).
"""

from captionkit_torch.kernels.attention import (  # noqa: F401
    fused_additive_attention,
    reference_additive_attention,
)
from captionkit_torch.kernels.head import (  # noqa: F401
    fused_head_topk,
    fused_head_topk_int8,
    fused_head_topk_thresh,
    head_sweep_topk,
    prepad_head,
    quantize_head,
    reference_head_topk,
    reference_head_topk_int8,
)
from captionkit_torch.kernels.lstm import (  # noqa: F401
    fused_copy_lstm_cell,
    fused_lstm_cell,
    reference_copy_lstm_cell,
    reference_lstm_cell,
)
from captionkit_torch.kernels.megastep import (  # noqa: F401
    att_cell,
    dcnet_cell,
    dcnet_score,
    lang_cell,
)
from captionkit_torch.kernels.wholestep import (  # noqa: F401
    fused_lang_head_topk,
    reference_lang_head_topk,
)

#: every kernel wrapper of the port, for resetting and reading the counts
WRAPPERS = (fused_head_topk, fused_head_topk_thresh, head_sweep_topk,
            fused_head_topk_int8, att_cell, lang_cell, dcnet_score,
            dcnet_cell, fused_lstm_cell, fused_copy_lstm_cell,
            fused_additive_attention, fused_lang_head_topk)
