"""The port's weight bridge and its isolation from the JAX package.

Weights go JAX -> ``captionkit.train.checkpoint.save_params_npz`` ->
``captionkit_torch.params.load_params_npz`` and back, bit for bit. A
subprocess imports every module of ``captionkit_torch`` and checks that
neither ``jax`` nor anything of ``captionkit`` was loaded (this process
has both: tests/conftest.py imports jax).
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from captionkit.models import get_model as jax_get_model
from captionkit.train.checkpoint import load_params_npz as jax_load_npz
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import ModelConfig as JaxModelConfig

import captionkit_torch
from captionkit_torch import params as bridge

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=40, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5)


def _flat_jax(params) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def test_jax_npz_round_trip_is_exact(tmp_path):
    for arch in ("editnet", "dcnet"):
        _round_trip(tmp_path / arch, arch)


def _round_trip(tmp_path, arch):
    tmp_path.mkdir()
    model = jax_get_model(JaxModelConfig(arch=arch, **SMALL))
    jp = model.init(jax.random.PRNGKey(3))
    jax_save_npz(jp, str(tmp_path / "jax.npz"))

    tp = bridge.load_params_npz(str(tmp_path / "jax.npz"), "cpu")
    ref = _flat_jax(jp)
    got = bridge.params_to_numpy(tp)
    names = bridge.EDITNET_NAMES if arch == "editnet" else bridge.DCNET_NAMES
    assert sorted(got) == sorted(ref) == sorted(names)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    # Layouts the port's modules rely on: [in, out], gates i|f|g|o, the
    # att-LSTM input rows packed [E | F | H], DCNet's decoder rows [E | H].
    E, F, H = SMALL["emb_dim"], SMALL["feat_dim"], SMALL["hidden_dim"]
    if arch == "editnet":
        assert tuple(tp.att_lstm.wx.shape) == (E + F + H, 4 * H)
    else:
        assert tuple(tp.decoder.wx.shape) == (E + H, 4 * H)
        assert tuple(tp.init_h_w.shape) == (H, H)
    assert tuple(tp.fc_w.shape) == (H, SMALL["vocab_size"])

    # Back: the port's writer gives a file the JAX loader takes.
    bridge.save_params_npz(tp, str(tmp_path / "torch.npz"))
    back = _flat_jax(jax_load_npz(jp, str(tmp_path / "torch.npz")))
    for name in ref:
        np.testing.assert_array_equal(back[name], ref[name], err_msg=name)


def test_missing_name_raises():
    arrays = {n: np.zeros((1,), np.float32) for n in bridge.EDITNET_NAMES}
    del arrays["lang_lstm/wrc"]
    with pytest.raises(KeyError, match="lang_lstm/wrc"):
        bridge.editnet_params_from_numpy(arrays, "cpu")


def test_port_imports_no_jax_and_nothing_of_captionkit():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(
            captionkit_torch.__path__, prefix="captionkit_torch."))
    assert "captionkit_torch.serve" in modules
    assert "captionkit_torch.kernels.head" in modules
    assert "captionkit_torch.kernels.megastep" in modules
    assert "captionkit_torch.models.dcnet" in modules
    assert "captionkit_torch.data.featquant" in modules
    for name in ("kernels.lstm", "kernels.attention", "kernels.wholestep",
                 "nn.dispatch", "decode.greedy", "metrics.eval",
                 "metrics.fast", "metrics.meteor", "metrics.external",
                 "data.prepare", "data.faststore", "utils.nativebuild",
                 "models.editnet_backward", "models.dcnet_backward",
                 "train.state", "train.xe", "train.checkpoint",
                 "train.loop", "utils.logging", "utils.preemption",
                 "train.scst", "models.ensemble", "decode.stacked",
                 "convert.torch_ref", "convert.torch_import",
                 "convert.fit_names", "convert.gate", "decode.introspect",
                 "data.prefetch", "utils.profiling", "parallel.mesh"):
        assert f"captionkit_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'captionkit')"
        " or m.startswith(('jax.', 'jaxlib', 'flax.', 'captionkit.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
