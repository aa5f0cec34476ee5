"""One module per architecture, ``archs/<arch>.py``, found by the
configuration's ``model.arch``. Everything the harness knows of a model
lives in its module; adding an architecture adds a file and edits none.

A module defines:

* ``make_weights(m, seed, device) -> dict``: the arrays, by name, that the
  program and the plain reference both get, made from the seed on the
  device (the module's own, so that a large model can draw in its own
  type or a layer at a time);
* ``program(model, weights, device) -> (ModelConfig, ModelDef, params)``:
  the port's model, built from the configuration's model fields and those
  weights;
* ``reference = (encode, state0, step)``: the plain float32 model
  (``encode(w, features, existing, lengths) -> ctx``, ``state0(w, ctx)
  -> state``, a tuple of [B, ...] tensors that the beam reorders by rows,
  ``step(w, ctx, state, token) -> (state, logits [B, V])``), ``w`` the
  weights as ``reference.model.Weights``;
* ``head(weights) -> (w [H, V], b [V])``: the float32 vocab head that
  ``head_err`` holds the program's head against;
* ``reads_features(m) -> bool``: whether the reference reads the region
  features (without them ``encode`` gets None);
* ``caption_flops(m, *, beam, steps, t) -> int``: the model FLOPs of one
  caption, which ``decode.mfu`` reads.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def get(name: str):
    """The module ``archs/<name>.py``, loaded by its file."""
    path = HERE / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", name) \
            or name == "__init__" or not path.is_file():
        have = sorted(p.stem for p in HERE.glob("*.py")
                      if p.stem != "__init__")
        raise KeyError(f"no architecture {name!r}: looked for "
                       f"ckbench/archs/{name}.py; have {have}")
    spec = importlib.util.spec_from_file_location(
        "ckbench_arch_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
