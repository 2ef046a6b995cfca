"""A configuration file of ``lcxbench/configs/`` as the program's
``ModelConfig``: the architecture the file names, with every size the
file states put in its place (``FIELDS`` and its family's ``fields``).
A setting the program cannot run as the file states it (``PROGRAM`` and
its family's ``program``) is refused here, before any weight is
drawn."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import families

# the file's key -> the program's field
FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab",
    "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings",
    "first_k_dense_replace": "first_k_dense",
    "n_routed_experts": "n_experts", "num_experts_per_tok":
    "n_experts_per_tok", "moe_intermediate_size": "moe_d_ff",
    "n_shared_experts": "n_shared_experts",
    "norm_topk_prob": "router_norm_topk", "scoring_func": "router_type",
    "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "num_nextn_predict_layers": "mtp_depth",
    "capacity_factor": "capacity_factor", "head_dim": "head_dim",
}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# what the program computes where a published file may say otherwise:
# key -> the program's value.  A file whose value differs names the key
# under ``departures`` (with what the program does instead), and the
# program runs its own value; otherwise the file is refused.
PROGRAM = {"hidden_act": "silu", "rope_scaling": None, "n_group": 1,
           "topk_group": 1, "routed_scaling_factor": 1.0,
           "attention_bias": False, "bias": False,
           "num_nextn_predict_layers": 0}


def _as_program(key: str, value: Any, program: Dict) -> bool:
    """Whether the file's ``value`` of ``key`` is what the program computes.
    Dynamic NTK rotary scaling changes no frequency up to
    ``max_position_embeddings``, past which no cell's cache reaches
    (``harness.build`` holds it), so it computes as none does."""
    if key == "rope_scaling" and isinstance(value, dict) \
            and value.get("type") == "dynamic":
        return True
    return value == program[key]


def port_config(cfg: Dict) -> Any:
    """The program's ``ModelConfig`` for the configuration file ``cfg``."""
    from repro_torch.configs.base import get_config
    fam = families.of(cfg)
    fields, program = {**FIELDS, **fam.fields}, {**PROGRAM, **fam.program}
    departs = cfg.get("departures", {})
    for key in program:
        if key in cfg and not _as_program(key, cfg[key], program) \
                and key not in departs:
            raise ValueError(f"{cfg['name']}: {key}={cfg[key]!r}, but the "
                             f"program computes {key}={program[key]!r} and "
                             f"the file names no such departure")
    base = get_config(cfg["arch"])
    over = {fields[k]: (program[k] if k in departs else v)
            for k, v in cfg.items() if k in fields}
    if "scoring_func" in cfg:
        over["router_type"] = {"sigmoid": "sigmoid",
                               "softmax": "softmax"}[cfg["scoring_func"]]
    dtype = DTYPES[cfg["torch_dtype"]]
    over.update(dtype=dtype, param_dtype=dtype, act="swiglu", norm="rms")
    if "head_dim" not in cfg:
        over["head_dim"] = cfg["hidden_size"] // cfg["num_attention_heads"]
    return dataclasses.replace(base, **over)


def check_layout(port_cfg: Any, params: Dict) -> None:
    """Raise unless ``params`` has the leaves, shapes and dtypes of the
    program's own ``init_model`` for ``port_cfg`` (counted on ``meta``)."""
    from repro_torch.models.model import init_model
    from .weights import flatten
    want = {k: (tuple(t.shape), t.dtype) for k, t in flatten(init_model(
        torch.Generator(), port_cfg, device="meta")).items()}
    got = {k: (tuple(t.shape), t.dtype) for k, t in flatten(params).items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()), key=str)[:6]
        raise ValueError(f"weights do not fit the program's layout: {diff}")


def check_kinds(cfg: Dict, port_cfg: Any) -> None:
    """Raise unless the family's ``layer_kinds`` of ``cfg`` are the
    program's layer plan for ``port_cfg``: the counts count the layers
    that run."""
    want = [(s.mixer, s.ffn) for s in port_cfg.layer_plan()]
    got = [tuple(k) for k in families.of(cfg).layer_kinds(cfg)]
    if want != got:
        bad = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
        raise ValueError(f"{cfg['name']}: the family's layer kinds {got[:8]}"
                         f" are not the program's plan {want[:8]} (first "
                         f"difference at layer {bad[:1] or len(got)})")
