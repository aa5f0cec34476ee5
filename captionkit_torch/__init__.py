"""captionkit_torch — the PyTorch + CUDA port of ``captionkit``.

The JAX package ``captionkit`` is the reference; this package runs the same
models on an NVIDIA Hopper card (H100, ``sm_90a``). It imports ``torch``
and numpy only: nothing of JAX and nothing of ``captionkit``. What it needs
from the reference's host code it keeps as its own copy.

Layout mirrors the reference's module names:

* ``config``          — the dataclass tree and the named configs
* ``data``            — vocab, tokenizer, static-shape batches, synthetic data,
                        the host->device feature feed
* ``nn``              — masking, LSTM / Copy-LSTM cells, additive attention
                        and SCMA, the lowest-index top-k helper
* ``params``          — the weight bridge from the reference's flat ``.npz``
* ``models``          — ``ModelDef``, EditNet, DCNet and checkpoint
                        ensembles
* ``kernels``         — hand-written CUDA kernels (``csrc/``), their build and
                        their wrappers; each has a plain PyTorch twin
* ``decode``          — beam search, greedy and sampling rollouts, the
                        stacked DCNet -> EditNet editor, the split-decode
                        driver
* ``train``           — XE and SCST training, the optimizer, checkpoints
* ``serve`` / ``cli`` — the JSON-lines caption server and its entry point

Numerics: TF32 is switched off for matmuls and for cuDNN when this package
is imported (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so a float32 product is a
float32 product on every device. Where the reference multiplies bfloat16
operands with a float32 result, ``nn.cells.mm`` does the same: on a card,
``torch.mm(..., out_dtype=torch.float32)`` on the bfloat16 operands (a
torch without that argument raises); on the CPU, the float32 product of
the operands rounded to bfloat16 (``nn.cells.matmul_route`` says which).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when CUDA is absent and the CPU was not asked
for (``device.resolve_device``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from captionkit_torch.config import (  # noqa: E402,F401
    CaptionKitConfig,
    DataConfig,
    DecodeConfig,
    ModelConfig,
    TrainConfig,
    get_named_config,
    list_named_configs,
)
from captionkit_torch.device import resolve_device  # noqa: E402,F401
