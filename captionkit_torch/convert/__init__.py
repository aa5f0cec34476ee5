"""PyTorch checkpoint interop (``captionkit.convert``).

* ``torch_import`` — a torch checkpoint's state dict -> the port's
  parameters / the shared flat ``.npz`` (the path for the authors'
  released checkpoints).
* ``fit_names`` — infer an unknown checkpoint's module layout from
  parameter shapes alone, for ``torch_import`` and the gate's sweep.
* ``torch_ref`` — torch twins of DCNet and EditNet with tutorial-family
  module names, and a batch=1 Python-loop beam search.
* ``gate`` — the parity gate: convert, greedy-identical against the twin,
  greedy against published captions, beam CIDEr.
"""
