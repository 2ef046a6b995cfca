"""Config schema for the port's architectures.

The port of ``repro/configs/base.py``: the same :class:`ModelConfig`
fields and layer plan, with torch dtypes.  One ``<arch>.py`` per ported
architecture instantiates it; :func:`get_config` resolves by id and each
config also provides a ``smoke()`` reduction for CPU tests.  Ported so
far: ``qwen2-0.5b``, ``mamba2-130m``, ``qwen3-moe-30b-a3b`` and
``jamba-1.5-large-398b``; the reference's other architectures come with
their model families (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "attn" | "mla" | "mamba"
    ffn: Optional[str]  # "dense" | "moe" | None


@dataclasses.dataclass
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"     # dense|moe|ssm|hybrid|encoder|vlm|audio

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None      # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    norm: str = "rms"
    norm_eps: float = 1e-6
    act: str = "swiglu"                 # swiglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False               # qwen3-style
    rope_theta: float = 10000.0
    causal: bool = True                 # False for encoder-only
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    max_seq_len: int = 8192

    # layer plan
    first_k_dense: int = 0              # prefix of plain dense layers
    attn_layer_period: int = 1          # hybrid: attention every k layers
    attn_layer_offset: int = 0
    expert_layer_period: int = 1        # MoE every k layers
    expert_layer_offset: int = 0
    scan_period: Optional[int] = None   # layers per scan step (auto)

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    router_type: str = "softmax"        # softmax | sigmoid (dsv3)
    router_norm_topk: bool = True
    capacity_factor: float = 1.25
    moe_backend: str = "lcx"
    moe_a2a: str = "native"
    aux_loss_coef: float = 0.001

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # multi-token prediction (deepseek v3)
    mtp_depth: int = 0
    mtp_loss_coef: float = 0.3

    # modality frontend stub
    frontend: Optional[str] = None      # None | "audio" | "vision"
    frontend_len: int = 0

    # numerics / memory
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    opt_dtype: torch.dtype = torch.float32
    remat: str = "full"
    # query-block size of the chunked attention path
    q_block: int = 256
    grad_accum: int = 1

    use_flash_kernel: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.head_dim is None:
            self.head_dim = self.d_model // max(self.n_heads, 1)

    # -- layer plan -----------------------------------------------------
    def layer_plan(self) -> List[LayerSpec]:
        plan: List[LayerSpec] = []
        for i in range(self.n_layers):
            if self.family in ("ssm",):
                plan.append(LayerSpec("mamba", None))
                continue
            if self.family == "hybrid":
                mixer = ("attn" if i % self.attn_layer_period ==
                         self.attn_layer_offset else "mamba")
            elif self.q_lora_rank or self.kv_lora_rank:
                mixer = "mla"
            else:
                mixer = "attn"
            if i < self.first_k_dense or self.n_experts == 0:
                ffn = "dense"
            elif i % self.expert_layer_period == self.expert_layer_offset:
                ffn = "moe"
            else:
                ffn = "dense"
            plan.append(LayerSpec(mixer, ffn))
        return plan

    def scan_plan(self) -> Tuple[List[LayerSpec], List[LayerSpec], int]:
        """Split the plan into (prefix, period_body, n_periods) so the body
        repeats exactly: the layout of the reference's stacked params."""
        plan = self.layer_plan()
        prefix = plan[: self.first_k_dense]
        rest = plan[self.first_k_dense:]
        period = self.scan_period
        if period is None:
            for p in range(1, len(rest) + 1):
                if len(rest) % p == 0 and all(
                        rest[i] == rest[i % p] for i in range(len(rest))):
                    period = p
                    break
        assert period is not None and len(rest) % period == 0, (
            self.name, period, len(rest))
        return prefix, rest[:period], len(rest) // period

    # -- derived sizes ----------------------------------------------------
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def kv_cache_spec(self, batch: int, seq: int) -> Dict[str, Any]:
        """Logical description of the decode cache (see serving/)."""
        return {"batch": batch, "seq": seq}


# registry ------------------------------------------------------------------
_REGISTRY: Dict[str, Any] = {}

ARCH_IDS = [
    "jamba-1.5-large-398b",
    "qwen2-0.5b",
    "command-r-plus-104b",
    "internlm2-20b",
    "starcoder2-7b",
    "hubert-xlarge",
    "mamba2-130m",
    "deepseek-v3-671b",
    "qwen3-moe-30b-a3b",
    "llava-next-mistral-7b",
]

# input-shape cells (LM family): seq_len x global_batch ---------------------
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# Shape-cell applicability, as the reference's:
#  - long_500k only for sub-quadratic archs (ssm/hybrid decode)
#  - decode shapes skipped for encoder-only archs
LONG_OK = {"mamba2-130m", "jamba-1.5-large-398b"}
ENCODER_ONLY = {"hubert-xlarge"}


def cells() -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            if SHAPES[shape]["kind"] == "decode" and arch in ENCODER_ONLY:
                continue
            out.append((arch, shape))
    return out


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{list_archs()}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _module(name)
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def list_archs() -> List[str]:
    return sorted(ARCH_IDS)
