"""Hand-written CUDA kernels of the port, their build and their wrappers.

Every wrapper sits beside a plain PyTorch version of the same function in
the same module. A wrapper uses the plain version only for tensors on the
CPU; on a CUDA tensor it launches its kernel or raises. Each wrapper counts
its launches in a plain integer attribute (``<wrapper>.launches``).
"""

from captionkit_torch.kernels.head import (  # noqa: F401
    fused_head_topk,
    prepad_head,
    reference_head_topk,
)
from captionkit_torch.kernels.megastep import (  # noqa: F401
    att_cell,
    dcnet_cell,
    dcnet_score,
    lang_cell,
)

#: every kernel wrapper of the port, for resetting and reading the counts
WRAPPERS = (fused_head_topk, att_cell, lang_cell, dcnet_score, dcnet_cell)
