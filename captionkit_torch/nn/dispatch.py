"""Kernel dispatch: plain cells or the fused cell kernels
(``captionkit.nn.dispatch``).

Models never import the cell kernels directly; they ask this module for
the cell functions at their call sites, with the default ``use_pallas=
False`` (the plain cells). ``use_pallas=True`` returns the kernel wrappers
of ``kernels/lstm.py`` and ``kernels/attention.py`` (the name is the JAX
package's). Where the reference falls back to the plain cells when Pallas
is unavailable, the wrappers follow the port's rule instead: their plain
versions for CPU tensors; for CUDA tensors they launch or raise.
"""

from __future__ import annotations

from typing import Callable

from captionkit_torch.nn import attention as _att
from captionkit_torch.nn import cells as _cells


def get_lstm_cell_fn(use_pallas: bool = False) -> Callable:
    if use_pallas:
        from captionkit_torch.kernels.lstm import fused_lstm_cell

        return fused_lstm_cell
    return _cells.lstm_cell


def get_copy_lstm_cell_fn(use_pallas: bool = False) -> Callable:
    if use_pallas:
        from captionkit_torch.kernels.lstm import fused_copy_lstm_cell

        return fused_copy_lstm_cell
    return _cells.copy_lstm_cell


def get_attention_fn(use_pallas: bool = False) -> Callable:
    if use_pallas:
        from captionkit_torch.kernels.attention import fused_additive_attention

        return fused_additive_attention
    return _att.additive_attention
