"""The benchmark's own marks around the port's kernel wrappers (traced runs
only).

Each call of a wrapped function runs inside ``record_function`` named
"ckbench.call.<wrapper>|<rows>|<images>|<attendable positions>", so the
trace reader finds the device work each call launched (``trace.Span``)
and the roofline readers find the call's shapes. The wrappers are
replaced where the port's callers look them up (the module attribute
that the calling function reads), and put back by ``uninstall``.
"""

from __future__ import annotations

import functools

#: wrapper name -> (module that calls it, attribute)
SITES = {
    "fused_head_topk": ("captionkit_torch.models.base", "fused_head_topk"),
    "att_cell": ("captionkit_torch.kernels.megastep", "att_cell"),
    "lang_cell": ("captionkit_torch.kernels.megastep", "lang_cell"),
    "dcnet_score": ("captionkit_torch.kernels.megastep", "dcnet_score"),
    "dcnet_cell": ("captionkit_torch.kernels.megastep", "dcnet_cell"),
}


def parse_call(name: str) -> tuple[str, int, int, int]:
    """(wrapper, rows, images, attendable positions) of a call's mark."""
    wrapper, rows, images, valid = name[len("ckbench.call."):].split("|")
    return wrapper, int(rows), int(images), int(valid)


class Marks:
    """Install the marks; ``batch`` says the images and attendable caption
    positions of the batch now being dispatched."""

    def __init__(self):
        self.images = 0
        self.valid = 0
        self._saved = {}

    def batch(self, images: int, valid: int) -> None:
        self.images, self.valid = images, valid

    def install(self) -> None:
        import importlib

        from torch.profiler import record_function

        for wrapper, (mod_name, attr) in SITES.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved[(mod_name, attr)] = fn

            def marked(*args, _fn=fn, _w=wrapper, **kw):
                rows = _rows(_w, args)
                with record_function(
                        f"ckbench.call.{_w}|{rows}|{self.images}|"
                        f"{self.valid}"):
                    return _fn(*args, **kw)

            setattr(mod, attr, functools.wraps(fn)(marked))

    def uninstall(self) -> None:
        import importlib

        for (mod_name, attr), fn in self._saved.items():
            setattr(importlib.import_module(mod_name), attr, fn)
        self._saved.clear()


def _rows(wrapper: str, args) -> int:
    """The call's rows: h of the head, emb or h of the cells (the second
    positional argument after the pack)."""
    if wrapper == "fused_head_topk":
        return int(args[0].shape[0])
    return int(args[1].shape[0])


class BeamScores:
    """Keeps the score of each image's served hypothesis from the port's
    beam search as the decode driver calls it (``decode.driver``'s
    ``beam_search``, which ``make_decode_fn`` looks up at each call): the
    result is handed back unchanged. ``last`` is the [B] fp32 score of
    the latest batch, on the device."""

    SITE = ("captionkit_torch.decode.driver", "beam_search")

    def __init__(self):
        self.last = None
        self._saved = None

    def install(self) -> None:
        import importlib

        mod = importlib.import_module(self.SITE[0])
        fn = self._saved = getattr(mod, self.SITE[1])

        def kept(*args, **kw):
            result = fn(*args, **kw)
            self.last = result.scores
            return result

        setattr(mod, self.SITE[1], functools.wraps(fn)(kept))

    def uninstall(self) -> None:
        import importlib

        if self._saved is not None:
            setattr(importlib.import_module(self.SITE[0]), self.SITE[1],
                    self._saved)
            self._saved = None


class HeadTap:
    """Keeps a sample of the vocab head's rows from the calls made while
    ``armed``: the hidden rows it was given and the top-k logits, ids and
    log-sum-exp it returned (the float head and the int8 head, where the
    model's head dispatch looks them up). The rows are drawn once per row
    count from ``seed``; the outputs are handed back unchanged."""

    SITES = (("captionkit_torch.models.base", "fused_head_topk"),
             ("captionkit_torch.models.base", "fused_head_topk_int8"))

    def __init__(self, rows: int, seed: int):
        self.rows, self.seed = rows, seed
        self.armed = False
        self.taken = []  # (h, vals, idx, lse) of the sampled rows, per call
        self._sel = {}
        self._saved = []

    def _rows(self, n, device):
        import torch

        sel = self._sel.get((n, device))
        if sel is None:
            g = torch.Generator().manual_seed(self.seed)
            sel = torch.randperm(n, generator=g)[:self.rows].sort().values
            sel = self._sel[(n, device)] = sel.to(device)
        return sel

    def install(self) -> None:
        import importlib

        for mod_name, attr in self.SITES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def tapped(h, *args, _fn=fn, **kw):
                out = _fn(h, *args, **kw)
                if self.armed:
                    sel = self._rows(h.shape[0], h.device)
                    self.taken.append(tuple(
                        t.index_select(0, sel) for t in (h, *out)))
                return out

            setattr(mod, attr, functools.wraps(fn)(tapped))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
