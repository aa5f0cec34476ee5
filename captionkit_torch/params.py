"""Weight bridge: the reference's flat ``.npz`` <-> the port's parameters.

``captionkit.train.checkpoint.save_params_npz`` writes one array per leaf
of the parameter pytree, named by its path joined with "/", e.g.
``embedding``, ``encoder/wx``, ``att_lstm/wx``, ``vis_attention/w_q``,
``lang_lstm/base/wx``, ``lang_lstm/wrc``, ``fc_w`` (EditNet) or
``attention/w_q``, ``decoder/wx``, ``init_h_w`` (DCNet). The port reads
and writes exactly those names and layouts ([in, out] weights, gates
i|f|g|o, ``att_lstm/wx`` rows packed [E | F | H], ``decoder/wx`` rows
packed [E | H (| F)]), so one file serves both packages. A file's arch is
told by its names: ``att_lstm/wx`` is EditNet's, ``decoder/wx`` DCNet's.
Kimi-VL's language model (``kimi_vl_params_from_tensors``) has no such
file: its parameters are built over flat tensors, without a copy.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from captionkit_torch.config import ModelConfig
from captionkit_torch.models.dcnet import DCNetParams
from captionkit_torch.models.editnet import EditNetParams
from captionkit_torch.models.kimi_vl import KimiLayer, KimiVLParams
from captionkit_torch.nn.attention import AdditiveAttentionParams
from captionkit_torch.nn.cells import CopyLSTMParams, LSTMParams
from captionkit_torch.nn.mla import MLAParams
from captionkit_torch.nn.moe import MoEParams

_LSTM = ("wx", "wh", "b")
_ATTENTION = ("w_enc", "w_q", "v", "b")

#: every array name of an EditNet checkpoint
EDITNET_NAMES = (
    ("embedding",)
    + tuple(f"encoder/{n}" for n in _LSTM)
    + tuple(f"att_lstm/{n}" for n in _LSTM)
    + tuple(f"vis_attention/{n}" for n in _ATTENTION)
    + ("vis_gate_w", "vis_gate_b")
    + tuple(f"scma/{n}" for n in _ATTENTION)
    + tuple(f"lang_lstm/base/{n}" for n in _LSTM)
    + ("lang_lstm/wrx", "lang_lstm/wrh", "lang_lstm/wrc", "lang_lstm/br",
       "fc_w", "fc_b")
)

#: every array name of a DCNet checkpoint; ``DCNET_VISUAL_NAMES`` join
#: them when ``dcnet_use_visual`` is on
DCNET_NAMES = (
    ("embedding",)
    + tuple(f"encoder/{n}" for n in _LSTM)
    + tuple(f"attention/{n}" for n in _ATTENTION)
    + ("gate_w", "gate_b")
    + tuple(f"decoder/{n}" for n in _LSTM)
    + ("fc_w", "fc_b", "init_h_w", "init_c_w", "init_h_b", "init_c_b")
)
DCNET_VISUAL_NAMES = tuple(f"vis_attention/{n}" for n in _ATTENTION)

Params = Union[EditNetParams, DCNetParams]


def _tensors(arrays: Mapping[str, np.ndarray], names, arch: str,
             device) -> dict[str, torch.Tensor]:
    missing = [n for n in names if n not in arrays]
    if missing:
        raise KeyError(f"{arch} checkpoint lacks {missing}")
    return {n: torch.from_numpy(np.array(arrays[n], dtype=np.float32)).to(
        device) for n in names}


def _lstm(t, prefix):
    return LSTMParams(*(t[f"{prefix}/{n}"] for n in _LSTM))


def _attention(t, prefix):
    return AdditiveAttentionParams(*(t[f"{prefix}/{n}"] for n in _ATTENTION))


def editnet_params_from_tensors(t: Mapping[str, torch.Tensor]
                                ) -> EditNetParams:
    """EditNetParams holding the named tensors themselves (no copy)."""
    return EditNetParams(
        embedding=t["embedding"],
        encoder=_lstm(t, "encoder"),
        att_lstm=_lstm(t, "att_lstm"),
        vis_attention=_attention(t, "vis_attention"),
        vis_gate_w=t["vis_gate_w"],
        vis_gate_b=t["vis_gate_b"],
        scma=_attention(t, "scma"),
        lang_lstm=CopyLSTMParams(
            base=_lstm(t, "lang_lstm/base"),
            wrx=t["lang_lstm/wrx"], wrh=t["lang_lstm/wrh"],
            wrc=t["lang_lstm/wrc"], br=t["lang_lstm/br"]),
        fc_w=t["fc_w"],
        fc_b=t["fc_b"],
    )


def dcnet_params_from_tensors(t: Mapping[str, torch.Tensor]) -> DCNetParams:
    """DCNetParams holding the named tensors themselves (no copy); the
    visual head when its names are present."""
    visual = any(n in t for n in DCNET_VISUAL_NAMES)
    return DCNetParams(
        embedding=t["embedding"],
        encoder=_lstm(t, "encoder"),
        attention=_attention(t, "attention"),
        gate_w=t["gate_w"],
        gate_b=t["gate_b"],
        decoder=_lstm(t, "decoder"),
        fc_w=t["fc_w"],
        fc_b=t["fc_b"],
        init_h_w=t["init_h_w"],
        init_h_b=t["init_h_b"],
        init_c_w=t["init_c_w"],
        init_c_b=t["init_c_b"],
        vis_attention=_attention(t, "vis_attention") if visual else None,
    )


def kimi_vl_params_from_tensors(t: Mapping[str, torch.Tensor],
                                cfg: ModelConfig) -> KimiVLParams:
    """KimiVLParams holding the named tensors themselves (no copy): the
    names of ``models.kimi_vl.weight_table`` in the published checkpoint's
    layouts ([out, in]; experts stacked [E, ...]; ``lm_head`` [H, V], the
    head kernel's), and a zero head bias."""
    layers = []
    for i in range(cfg.num_layers):
        p = f"layers/{i}/"
        attn = MLAParams(*(t[p + "attn/" + n] for n in (
            "q_proj", "kv_a", "kv_a_norm", "kv_b", "o_proj")))
        if p + "mlp/gate_up" in t:
            layer = KimiLayer(t[p + "input_norm"], attn, t[p + "post_norm"],
                              gate_up=t[p + "mlp/gate_up"],
                              down=t[p + "mlp/down"])
        else:
            layer = KimiLayer(t[p + "input_norm"], attn, t[p + "post_norm"],
                              moe=MoEParams(*(t[p + "moe/" + n] for n in (
                                  "router", "router_bias", "experts_gate_up",
                                  "experts_down", "shared_gate_up",
                                  "shared_down"))))
        layers.append(layer)
    head = t["lm_head"]
    return KimiVLParams(
        *(t["projector/" + n] for n in ("norm_w", "norm_b", "fc1_w", "fc1_b",
                                        "fc2_w", "fc2_b")),
        embed=t["embed_tokens"], layers=layers, norm=t["norm"], fc_w=head,
        fc_b=torch.zeros(head.shape[1], dtype=torch.float32,
                         device=head.device))


def editnet_params_from_numpy(arrays: Mapping[str, np.ndarray],
                              device: "str | torch.device") -> EditNetParams:
    """EditNetParams (float32 tensors on ``device``) from flat named
    arrays. Raises on a missing name."""
    return editnet_params_from_tensors(
        _tensors(arrays, EDITNET_NAMES, "EditNet", device))


def dcnet_params_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: "str | torch.device") -> DCNetParams:
    """DCNetParams (float32 tensors on ``device``) from flat named arrays;
    the visual head when its names are present. Raises on a missing
    name."""
    visual = any(n in arrays for n in DCNET_VISUAL_NAMES)
    names = DCNET_NAMES + (DCNET_VISUAL_NAMES if visual else ())
    return dcnet_params_from_tensors(_tensors(arrays, names, "DCNet", device))


def _names(params: Params) -> tuple[str, ...]:
    if isinstance(params, EditNetParams):
        return EDITNET_NAMES
    if params.vis_attention is not None:
        return DCNET_NAMES + DCNET_VISUAL_NAMES
    return DCNET_NAMES


def named_tensors(params: Params) -> dict[str, torch.Tensor]:
    """Every weight of ``params`` by its checkpoint name, the tensors
    themselves (no copy)."""
    def get(name):
        obj = params
        for part in name.split("/"):
            obj = getattr(obj, part)
        return obj

    return {name: get(name) for name in _names(params)}


def params_from_tensors(tensors: Mapping[str, torch.Tensor],
                        like: Params) -> Params:
    """A parameter object of ``like``'s arch holding ``tensors`` (no copy),
    with empty packed-weight caches."""
    if isinstance(like, EditNetParams):
        return editnet_params_from_tensors(tensors)
    return dcnet_params_from_tensors(tensors)


def params_to_numpy(params: Params) -> dict[str, np.ndarray]:
    """The inverse of ``editnet_params_from_numpy`` and
    ``dcnet_params_from_numpy``, for either arch."""
    return {name: t.detach().float().cpu().numpy()
            for name, t in named_tensors(params).items()}


def params_arch(arrays: Mapping[str, np.ndarray]) -> str:
    """"editnet" or "dcnet", from a checkpoint's names."""
    if "att_lstm/wx" in arrays:
        return "editnet"
    if "decoder/wx" in arrays:
        return "dcnet"
    raise KeyError("neither an EditNet (att_lstm/wx) nor a DCNet "
                   "(decoder/wx) checkpoint")


def save_params_npz(params: Params, path: str) -> None:
    """Write the reference's flat ``.npz`` interchange format."""
    np.savez(path, **params_to_numpy(params))


def load_params_npz(path: str, device: "str | torch.device",
                    arch: Optional[str] = None) -> Params:
    """Read a ``.npz`` written by either package's ``save_params_npz``.
    ``arch`` ("editnet" or "dcnet"), when given, must be the file's."""
    with np.load(path) as data:
        arrays = {n: data[n] for n in data.files}
    found = params_arch(arrays)
    if arch is not None and arch != found:
        raise ValueError(f"{path} holds {found} weights, not {arch}")
    if found == "editnet":
        return editnet_params_from_numpy(arrays, device)
    return dcnet_params_from_numpy(arrays, device)
