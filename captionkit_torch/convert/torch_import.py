"""Torch checkpoint -> the port's parameters (``captionkit.convert.
torch_import``).

The module names follow the tutorial-family layout of ``torch_ref`` (the
released PyTorch code's shape); they are an overridable data table
(``DEFAULT_NAME_MAPS`` plus a JSON/dict override), so fitting another
checkpoint layout is a data edit, not a code change. Conversion rules:

* torch Linear weight [out, in] -> transposed [in, out].
* torch LSTM gate blocks stay in (i, f, g, o) order; bias_ih + bias_hh sum
  into one bias.
* additive attention: the single in-tanh bias b := encoder_att.bias +
  decoder_att.bias; full_att.bias shifts every score by a constant and is
  softmax-invariant, so it is checked and dropped.
* the att-LSTM's (EditNet) and the decoder's (DCNet) input rows keep the
  twin's concatenation order, which is the order ``params.py`` documents:
  [E | F | H] and [E | H (| F)].

Every array is made in numpy float32, each sum in the reference's order,
so the flat arrays (``params.params_to_numpy``) are bit-equal to the ones
the reference's converter writes. The parameters then go to the device
the caller names, with no JAX pytree in between.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from captionkit_torch.params import (
    Params,
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
    save_params_npz,
)

# -- name-map indirection ----------------------------------------------------
# Logical component -> checkpoint module prefix. '__'-keys customize
# cross-cutting conventions: a global key prefix to strip, LSTM leaf names,
# attention sub-module names. Override any subset via `name_map=` (or the
# CLI's --name-map JSON file).

_COMMON = {
    "__strip_prefix__": "",
    "__lstm_wih__": "weight_ih",
    "__lstm_whh__": "weight_hh",
    "__lstm_bih__": "bias_ih",
    "__lstm_bhh__": "bias_hh",
    "__att_enc__": "encoder_att",
    "__att_dec__": "decoder_att",
    "__att_full__": "full_att",
    "__linear_w__": "weight",
    "__linear_b__": "bias",
    "__ignore_prefixes__": [],
}

DEFAULT_NAME_MAPS: dict[str, dict[str, object]] = {
    "dcnet": {
        **_COMMON,
        "embedding": "embedding.weight",
        "encoder": "encoder",
        "attention": "attention",
        "gate": "f_beta",
        "decoder": "decode_step",
        "fc": "fc",
        "init_h": "init_h",
        "init_c": "init_c",
        # Visual variant (dcnet_use_visual): converted when the checkpoint
        # carries the module, absent otherwise.
        "vis_attention": "vis_attention",
    },
    "editnet": {
        **_COMMON,
        "embedding": "embedding.weight",
        "encoder": "encoder",
        "att_lstm": "att_lstm",
        "vis_attention": "vis_attention",
        "vis_gate": "f_beta",
        "scma": "scma",
        "lang_lstm": "lang_lstm",
        "lang_lstm.base": "base",
        "lang_lstm.wrx": "weight_rx",
        "lang_lstm.wrh": "weight_rh",
        "lang_lstm.wrc": "weight_rc",
        "lang_lstm.br": "bias_r",
        "fc": "fc",
    },
}


def resolve_name_map(
    arch: str, override: Optional[Mapping[str, object]] = None
) -> dict[str, object]:
    """Default map for `arch`, with `override` entries layered on top."""
    if arch not in DEFAULT_NAME_MAPS:
        raise ValueError(f"unknown arch {arch!r}")
    out = dict(DEFAULT_NAME_MAPS[arch])
    if override:
        unknown = set(override) - set(out)
        if unknown:
            raise KeyError(
                f"name-map override has unknown entries {sorted(unknown)}; "
                f"valid entries: {sorted(out)}"
            )
        out.update(override)
    return out


def _np(t) -> np.ndarray:
    try:  # torch tensor
        return t.detach().cpu().numpy().astype(np.float32)
    except AttributeError:
        return np.asarray(t, np.float32)


class StateDict:
    """Tracks consumed keys so unmapped parameters are loud, not silent."""

    def __init__(self, raw: Mapping[str, object], strip_prefix: str = ""):
        if strip_prefix:
            raw = {
                (k[len(strip_prefix):] if k.startswith(strip_prefix) else k):
                    v
                for k, v in raw.items()
            }
        self.raw = dict(raw)
        self.used: set[str] = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.raw:
            raise KeyError(
                f"checkpoint is missing {key!r}; available keys include "
                f"{sorted(self.raw)[:8]}..."
            )
        self.used.add(key)
        return _np(self.raw[key])

    def take_optional(self, key: str):
        if key in self.raw:
            return self.take(key)
        return None

    def assert_exhausted(self, ignore_prefixes: tuple[str, ...] = ()):
        left = [
            k for k in self.raw
            if k not in self.used
            and not any(k.startswith(p) for p in ignore_prefixes)
        ]
        if left:
            raise ValueError(f"unconverted checkpoint keys: {sorted(left)}")


def _under(prefix: str, arrays: Mapping[str, np.ndarray]
           ) -> dict[str, np.ndarray]:
    """``arrays`` named under ``prefix/`` (the flat ``.npz`` names)."""
    return {f"{prefix}/{k}": v for k, v in arrays.items()}


def lstm_from(sd: StateDict, prefix: str, nm: Mapping[str, object]
              ) -> dict[str, np.ndarray]:
    """{"wx" [in, 4H], "wh" [H, 4H], "b" [4H]} of one LSTM."""
    wih = sd.take(f"{prefix}.{nm['__lstm_wih__']}")
    whh = sd.take(f"{prefix}.{nm['__lstm_whh__']}")
    b = (sd.take(f"{prefix}.{nm['__lstm_bih__']}")
         + sd.take(f"{prefix}.{nm['__lstm_bhh__']}"))
    return {"wx": wih.T.copy(), "wh": whh.T.copy(), "b": b}


def _linear(sd: StateDict, prefix: str, nm: Mapping[str, object]):
    return (sd.take(f"{prefix}.{nm['__linear_w__']}").T.copy(),
            sd.take(f"{prefix}.{nm['__linear_b__']}"))


def attention_from(sd: StateDict, prefix: str, nm: Mapping[str, object]
                   ) -> dict[str, np.ndarray]:
    """{"w_enc", "w_q", "v", "b"} of one additive attention."""
    w, b = nm["__linear_w__"], nm["__linear_b__"]
    w_enc = sd.take(f"{prefix}.{nm['__att_enc__']}.{w}").T.copy()
    b_enc = sd.take(f"{prefix}.{nm['__att_enc__']}.{b}")
    w_q = sd.take(f"{prefix}.{nm['__att_dec__']}.{w}").T.copy()
    b_q = sd.take(f"{prefix}.{nm['__att_dec__']}.{b}")
    v = sd.take(f"{prefix}.{nm['__att_full__']}.{w}").reshape(-1)
    # softmax-invariant score shift: checked-and-dropped
    sd.take_optional(f"{prefix}.{nm['__att_full__']}.{b}")
    return {"w_enc": w_enc, "w_q": w_q, "v": v, "b": b_enc + b_q}


def copy_lstm_from(sd: StateDict, prefix: str, nm: Mapping[str, object]
                   ) -> dict[str, np.ndarray]:
    """The Copy-LSTM's base LSTM (``base/*``) and its copy gate."""
    base = lstm_from(sd, f"{prefix}.{nm['lang_lstm.base']}", nm)
    return {
        **_under("base", base),
        "wrx": sd.take(f"{prefix}.{nm['lang_lstm.wrx']}").T.copy(),
        "wrh": sd.take(f"{prefix}.{nm['lang_lstm.wrh']}").T.copy(),
        "wrc": sd.take(f"{prefix}.{nm['lang_lstm.wrc']}").T.copy(),
        "br": sd.take(f"{prefix}.{nm['lang_lstm.br']}"),
    }


def dcnet_arrays_from_state_dict(
    raw: Mapping[str, object],
    name_map: Optional[Mapping[str, object]] = None,
) -> dict[str, np.ndarray]:
    """DCNet's flat float32 arrays (``params.DCNET_NAMES``, plus
    ``DCNET_VISUAL_NAMES`` when the checkpoint has the visual module),
    with strict key exhaustion."""
    nm = resolve_name_map("dcnet", name_map)
    sd = StateDict(raw, strip_prefix=str(nm["__strip_prefix__"]))
    gate_w, gate_b = _linear(sd, str(nm["gate"]), nm)
    fc_w, fc_b = _linear(sd, str(nm["fc"]), nm)
    init_h_w, init_h_b = _linear(sd, str(nm["init_h"]), nm)
    init_c_w, init_c_b = _linear(sd, str(nm["init_c"]), nm)
    # Visual variant: convert the module when the checkpoint has it
    # (dcnet_use_visual decides at model-build time; a text-only
    # checkpoint simply lacks these keys).
    vis_prefix = f"{nm['vis_attention']}.{nm['__att_enc__']}"
    has_visual = any(k.startswith(vis_prefix + ".") for k in sd.raw)
    arrays = {
        "embedding": sd.take(str(nm["embedding"])),
        **_under("encoder", lstm_from(sd, str(nm["encoder"]), nm)),
        **_under("attention", attention_from(sd, str(nm["attention"]), nm)),
        "gate_w": gate_w,
        "gate_b": gate_b,
        **_under("decoder", lstm_from(sd, str(nm["decoder"]), nm)),
        "fc_w": fc_w,
        "fc_b": fc_b,
    }
    if has_visual:
        arrays.update(_under("vis_attention", attention_from(
            sd, str(nm["vis_attention"]), nm)))
    arrays.update(init_h_w=init_h_w, init_c_w=init_c_w, init_h_b=init_h_b,
                  init_c_b=init_c_b)
    sd.assert_exhausted(tuple(nm["__ignore_prefixes__"]))
    return arrays


def editnet_arrays_from_state_dict(
    raw: Mapping[str, object],
    name_map: Optional[Mapping[str, object]] = None,
) -> dict[str, np.ndarray]:
    """EditNet's flat float32 arrays (``params.EDITNET_NAMES``), with
    strict key exhaustion."""
    nm = resolve_name_map("editnet", name_map)
    sd = StateDict(raw, strip_prefix=str(nm["__strip_prefix__"]))
    vis_gate_w, vis_gate_b = _linear(sd, str(nm["vis_gate"]), nm)
    fc_w, fc_b = _linear(sd, str(nm["fc"]), nm)
    arrays = {
        "embedding": sd.take(str(nm["embedding"])),
        **_under("encoder", lstm_from(sd, str(nm["encoder"]), nm)),
        **_under("att_lstm", lstm_from(sd, str(nm["att_lstm"]), nm)),
        **_under("vis_attention",
                 attention_from(sd, str(nm["vis_attention"]), nm)),
        "vis_gate_w": vis_gate_w,
        "vis_gate_b": vis_gate_b,
        **_under("scma", attention_from(sd, str(nm["scma"]), nm)),
        **_under("lang_lstm", copy_lstm_from(sd, str(nm["lang_lstm"]), nm)),
        "fc_w": fc_w,
        "fc_b": fc_b,
    }
    sd.assert_exhausted(tuple(nm["__ignore_prefixes__"]))
    return arrays


def dcnet_params_from_state_dict(
    raw: Mapping[str, object],
    name_map: Optional[Mapping[str, object]] = None,
    device: "str | torch.device" = "cuda",
):
    """``DCNetParams`` on ``device`` from a torch state dict."""
    return dcnet_params_from_numpy(
        dcnet_arrays_from_state_dict(raw, name_map), device)


def editnet_params_from_state_dict(
    raw: Mapping[str, object],
    name_map: Optional[Mapping[str, object]] = None,
    device: "str | torch.device" = "cuda",
):
    """``EditNetParams`` on ``device`` from a torch state dict."""
    return editnet_params_from_numpy(
        editnet_arrays_from_state_dict(raw, name_map), device)


def load_torch_state_dict(path: str) -> Mapping[str, object]:
    """Load a torch .pth/.pth.tar checkpoint and return its state dict.

    Accepts either a bare state_dict, a whole saved nn.Module, or the
    reference's training dict {epoch, model/state_dict/decoder, optimizer,
    ...}. Whole modules are unpickled (``weights_only=False``, which torch
    2.6 and later no longer default to), so their classes are imported by
    their module paths: load only files you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(blob, "state_dict"):  # whole nn.Module saved
        raw = blob.state_dict()
    elif isinstance(blob, dict) and not any(
        hasattr(v, "detach") for v in blob.values()
    ):
        for key in ("state_dict", "model", "decoder"):
            if key in blob:
                raw = blob[key]
                if hasattr(raw, "state_dict"):
                    raw = raw.state_dict()
                break
        else:
            raise ValueError(
                f"could not find a state_dict in checkpoint keys "
                f"{sorted(blob)}"
            )
    else:
        raw = blob
    return raw


def params_from_state_dict(
    raw: Mapping[str, object],
    arch: str,
    name_map: Optional[Mapping[str, object]] = None,
    device: "str | torch.device" = "cuda",
) -> Params:
    if arch == "dcnet":
        return dcnet_params_from_state_dict(raw, name_map, device)
    if arch == "editnet":
        return editnet_params_from_state_dict(raw, name_map, device)
    raise ValueError(f"unknown arch {arch!r}")


def convert_torch_checkpoint(
    path: str,
    arch: str,
    out_path: str,
    name_map: Optional[Mapping[str, object]] = None,
) -> str:
    """torch checkpoint file -> params .npz file (host work: the arrays
    stay on the CPU)."""
    raw = load_torch_state_dict(path)
    save_params_npz(params_from_state_dict(raw, arch, name_map, "cpu"),
                    out_path)
    return out_path
