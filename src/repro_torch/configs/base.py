"""Config system: ModelConfig dataclass, input-shape specs, registry (a
copy of ``repro.configs.base``, which is pure stdlib: the port imports
nothing of the JAX package)."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "register", "get_config",
           "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | tm
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # local attention: sliding window (starcoder2) / chunked (llama4)
    window: int = 0
    chunk: int = 0
    global_every: int = 0        # every k-th layer uses full attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    first_dense: int = 0         # leading dense-FFN layers (deepseek: 1)
    # MLA
    use_mla: bool = False
    kv_lora: int = 512
    q_lora: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # hybrid (zamba2): one shared attention block applied every k mamba layers
    shared_attn_every: int = 0
    # enc-dec
    n_enc_layers: int = 0
    enc_len_ratio: int = 4       # encoder frames = seq_len // ratio
    # modality prefix stub (vlm): patch embeddings prepended
    prefix_len: int = 0
    # TM-family inference: VoteEngine backend (repro.engine registry) and
    # whether to shard_map infer over the batch axis for multi-device serving
    backend: str = "oracle"
    shard_batch: bool = False
    # sharding rule overrides (logical axis -> mesh axis or None)
    rules_overrides: tuple[tuple[str, Any], ...] = ()
    # which shapes this arch supports (long_500k only for sub-quadratic)
    supports_long: bool = False
    notes: str = ""

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from . import _load_all
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
