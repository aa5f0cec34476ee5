"""Configuration: the JAX package's dataclass tree, copied as plain data.

Field names, defaults and the ``NAMED_CONFIGS`` table are the same as in
``captionkit.utils.config`` so that one named config means one model on
both sides. The knobs that select TPU kernels (``head_impl``,
``cell_impl``, ``head_quant``, ``head_extract``) are kept with their
values and select the port's hand-written counterparts.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of DCNet, EditNet and Kimi-VL's
    language model (``arch="kimi_vl"``; the fields below ``head_extract``
    are its own, with its published values as defaults, and EditNet and
    DCNet read none of them)."""

    arch: str = "editnet"  # "dcnet" | "editnet" | "kimi_vl"
    vocab_size: int = 9490
    emb_dim: int = 1024
    hidden_dim: int = 1024
    att_dim: int = 512
    feat_dim: int = 2048  # bottom-up region feature dim
    num_regions: int = 36  # bottom-up regions per image
    dropout: float = 0.5
    scma_select: str = "soft"  # "soft" | "hard"
    dcnet_use_visual: bool = False
    # Matmul operand dtype; parameters and gate math stay fp32.
    compute_dtype: str = "bfloat16"
    # Beam decode through the fused vocab-head top-k (kernels/head.py).
    use_fused_head: bool = True
    deferred_backward: bool = True
    dcnet_deferred_backward: bool = False
    # "pallas": the hand-written head kernel; "xla": plain full logits ->
    # top-k + logsumexp (the name is the JAX package's).
    head_impl: str = "pallas"
    cell_impl: str = "xla"
    # "int8": the beam decode's head runs on per-column int8 weights and
    # per-row int8 activations (kernels/head.py::fused_head_topk_int8). An
    # explicit serving trade, never the default: quantization may flip
    # near-tie beam choices. Greedy/teacher-forced logits stay float.
    head_quant: str = "none"
    # The head kernels' per-tile top-k extraction, "mask" or "thresh"
    # (read-only thresholds); the results are identical.
    head_extract: str = "mask"
    # Kimi-VL-A3B's language model (DeepSeek-V3 layout; models/kimi_vl.py).
    # hidden_dim is its hidden size, vocab_size its vocabulary, feat_dim and
    # num_regions the region features its projector reads.
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264  # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408  # one routed expert's SwiGLU
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1  # leading dense layers
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    projector_dim: int = 4608  # the MLP projector's hidden width

    def __post_init__(self) -> None:
        choices = {
            "arch": ("dcnet", "editnet", "kimi_vl"),
            "scma_select": ("soft", "hard"),
            "head_impl": ("pallas", "xla"),
            "cell_impl": ("pallas", "xla", "wholestep"),
            "head_quant": ("none", "int8"),
            "head_extract": ("mask", "thresh"),
        }
        for name, allowed in choices.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"ModelConfig.{name} must be one of {allowed}, "
                    f"got {value!r}")
        if self.head_quant == "int8" and self.arch == "dcnet":
            warnings.warn(
                "head_quant='int8' with arch='dcnet': the int8 head is an "
                "EditNet serving trade; DCNet's step is short, so the "
                "per-batch quantization and the in-kernel row quantization "
                "weigh more against the head's saving. Measure it on your "
                "card (PERF.md) before serving DCNet with it.",
                stacklevel=2)

    @property
    def pad_id(self) -> int:
        return 0


@dataclass(frozen=True)
class DataConfig:
    max_len: int = 22
    max_existing_len: int = 22
    batch_size: int = 256
    min_word_freq: int = 5
    features_path: str = ""
    captions_path: str = ""
    existing_captions_path: str = ""
    wordmap_path: str = ""
    captions_per_image: int = 5
    shuffle_buffer: int = 4096
    seed: int = 0
    bucket_boundaries: tuple[int, ...] = ()


@dataclass(frozen=True)
class TrainConfig:
    """Kept as a plain copy so that ``train.*`` overrides of the named
    configs parse; the serving slice reads none of it."""

    optimizer: str = "adam"
    learning_rate: float = 4e-4
    scst_learning_rate: float = 5e-5
    scst_num_samples: int = 1
    grad_clip: float = 5.0
    epochs: int = 30
    scst_epochs: int = 10
    lr_decay_factor: float = 0.8
    lr_decay_patience: int = 3
    early_stop_patience: int = 10
    label_smoothing: float = 0.0
    ema_decay: float = 0.0
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 100
    eval_every_epochs: int = 1
    mesh_shape: tuple[int, ...] = (-1,)
    mesh_axis_names: tuple[str, ...] = ("data",)
    donate_state: bool = True
    steps_per_dispatch: int = 8
    seed: int = 42


@dataclass(frozen=True)
class DecodeConfig:
    method: str = "beam"  # "greedy" | "beam" | "sample"
    beam_size: int = 5
    max_decode_len: int = 22
    length_penalty: float = 0.0  # 0 = sum of log-probs
    batch_size: int = 256
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # Host->device dtype of the region features: "float32", "bfloat16", or
    # "int8" (per-region quantization on the host, dequantized on the
    # device; data/featquant.py).
    feed_dtype: str = "float32"
    # Beam-search sequence-history layout (decode/beam.py): "register"
    # carries the [B, K, L] sequences through the loop; "backptr" records
    # each step's [B, K] tokens and parents and rebuilds the sequences once
    # after the loop. The results are identical. The reference warns when
    # "backptr" meets cell_impl="pallas" because that pair took minutes to
    # compile on a TPU; nothing is compiled here, so the port takes the
    # pair without a warning.
    beam_impl: str = "register"

    def __post_init__(self) -> None:
        if self.feed_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"decode.feed_dtype must be one of float32/bfloat16/int8,"
                f" got {self.feed_dtype!r}")
        if self.beam_impl not in ("register", "backptr"):
            raise ValueError(
                f"decode.beam_impl must be 'register' or 'backptr', got "
                f"{self.beam_impl!r}")


@dataclass(frozen=True)
class CaptionKitConfig:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    def replace(self, **kw: Any) -> "CaptionKitConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def override(self, dotted: dict[str, Any]) -> "CaptionKitConfig":
        """Apply CLI-style overrides like {"model.emb_dim": 512}."""
        out = self
        for key, value in dotted.items():
            section, _, leaf = key.partition(".")
            if not leaf:
                out = dataclasses.replace(out, **{section: value})
                continue
            sub = getattr(out, section)
            out = dataclasses.replace(
                out, **{section: dataclasses.replace(sub, **{leaf: value})})
        return out


def _mk(name: str, **kw: Any) -> CaptionKitConfig:
    return CaptionKitConfig(name=name).override(kw)


NAMED_CONFIGS: dict[str, CaptionKitConfig] = {
    "dcnet_greedy": _mk(
        "dcnet_greedy",
        **{"model.arch": "dcnet", "decode.method": "greedy",
           "decode.beam_size": 1}),
    "editnet_greedy": _mk(
        "editnet_greedy",
        **{"model.arch": "editnet", "decode.method": "greedy",
           "decode.beam_size": 1}),
    # The port's main path: EditNet at paper scale, beam 5.
    "editnet_beam5": _mk(
        "editnet_beam5",
        **{"model.arch": "editnet", "decode.method": "beam",
           "decode.beam_size": 5}),
    "xe_train": _mk("xe_train", **{"model.arch": "editnet"}),
    "scst_train": _mk(
        "scst_train",
        **{"model.arch": "editnet", "train.scst_learning_rate": 5e-5}),
    "dcnet_beam5": _mk(
        "dcnet_beam5",
        **{"model.arch": "dcnet", "decode.method": "beam",
           "decode.beam_size": 5}),
    "dcnet_xe_train": _mk("dcnet_xe_train", **{"model.arch": "dcnet"}),
    "dcnet_scst_train": _mk(
        "dcnet_scst_train",
        **{"model.arch": "dcnet", "train.scst_learning_rate": 5e-5}),
}


def get_named_config(name: str) -> CaptionKitConfig:
    try:
        return NAMED_CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(NAMED_CONFIGS)}"
        ) from None


def list_named_configs() -> list[str]:
    return sorted(NAMED_CONFIGS)
