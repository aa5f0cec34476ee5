"""Weight bridge: the reference's flat ``.npz`` <-> the port's parameters.

``captionkit.train.checkpoint.save_params_npz`` writes one array per leaf
of the parameter pytree, named by its path joined with "/", e.g.
``embedding``, ``encoder/wx``, ``att_lstm/wx``, ``vis_attention/w_q``,
``lang_lstm/base/wx``, ``lang_lstm/wrc``, ``fc_w``. The port reads and
writes exactly those names and layouts ([in, out] weights, gates i|f|g|o,
``att_lstm/wx`` rows packed [E | F | H]), so one file serves both
packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from captionkit_torch.models.editnet import EditNetParams
from captionkit_torch.nn.attention import AdditiveAttentionParams
from captionkit_torch.nn.cells import CopyLSTMParams, LSTMParams

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


def editnet_params_from_numpy(arrays: Mapping[str, np.ndarray],
                              device: "str | torch.device") -> EditNetParams:
    """EditNetParams (float32 tensors on ``device``) from flat named
    arrays. Raises on a missing name."""
    missing = [n for n in EDITNET_NAMES if n not in arrays]
    if missing:
        raise KeyError(f"EditNet checkpoint lacks {missing}")

    def t(name):
        return torch.from_numpy(
            np.array(arrays[name], dtype=np.float32)).to(device)

    def lstm(prefix):
        return LSTMParams(*(t(f"{prefix}/{n}") for n in _LSTM))

    def attention(prefix):
        return AdditiveAttentionParams(*(t(f"{prefix}/{n}") for n in _ATTENTION))

    return EditNetParams(
        embedding=t("embedding"),
        encoder=lstm("encoder"),
        att_lstm=lstm("att_lstm"),
        vis_attention=attention("vis_attention"),
        vis_gate_w=t("vis_gate_w"),
        vis_gate_b=t("vis_gate_b"),
        scma=attention("scma"),
        lang_lstm=CopyLSTMParams(
            base=lstm("lang_lstm/base"),
            wrx=t("lang_lstm/wrx"), wrh=t("lang_lstm/wrh"),
            wrc=t("lang_lstm/wrc"), br=t("lang_lstm/br")),
        fc_w=t("fc_w"),
        fc_b=t("fc_b"),
    )


def editnet_params_to_numpy(params: EditNetParams) -> dict[str, np.ndarray]:
    """The inverse of ``editnet_params_from_numpy``."""
    def get(name):
        obj = params
        for part in name.split("/"):
            obj = getattr(obj, part)
        return obj.detach().float().cpu().numpy()

    return {name: get(name) for name in EDITNET_NAMES}


def save_params_npz(params: EditNetParams, path: str) -> None:
    """Write the reference's flat ``.npz`` interchange format."""
    np.savez(path, **editnet_params_to_numpy(params))


def load_params_npz(path: str,
                    device: "str | torch.device") -> EditNetParams:
    """Read a ``.npz`` written by either package's ``save_params_npz``."""
    with np.load(path) as data:
        return editnet_params_from_numpy(
            {n: data[n] for n in data.files}, device)
