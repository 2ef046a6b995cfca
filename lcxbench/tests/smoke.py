"""Smoke-size cells for the CPU tests: the cells' configuration files with
their widths shrunk and float32, small mixes, loose limits."""
from __future__ import annotations

import copy
from typing import Dict

from lcxbench import bench
from lcxbench.bench import Cell

DSV3 = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            intermediate_size=160, moe_intermediate_size=64,
            n_routed_experts=8, num_experts_per_tok=2, num_hidden_layers=3,
            first_k_dense_replace=1, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            vocab_size=128, capacity_factor=1.0, torch_dtype="float32")
INTERNLM2 = dict(hidden_size=96, num_attention_heads=6,
                 num_key_value_heads=2, intermediate_size=256,
                 num_hidden_layers=2, vocab_size=128,
                 torch_dtype="float32")


def config(name: str, **extra) -> Dict:
    cfg = bench.load_json(bench.HERE / "configs" / f"{name}.json")
    cfg.update(DSV3 if cfg["arch"].startswith("deepseek") else INTERNLM2)
    cfg.update(extra)
    return cfg


def mix(loop: str = "open", **extra) -> Dict:
    m = {"loop": loop, "n_slots": 4, "rate_rps": 40.0, "clients": 4,
         "prompt": {"dist": "loguniform", "min": 8, "max": 32},
         "output": {"dist": "loguniform", "min": 2, "max": 8},
         "sampling": "greedy", "trace_ticks": 4}
    m.update(extra)
    return m


def limits(config_name: str, limit: float = 1e-3,
           missed: float = 0.05) -> Dict:
    """The numbers a cell of ``config_name`` compares, as its limits file
    names them: with routed experts the widest gap where the routing is
    clear (margin 0.01 at this size), the share of chosen experts the
    reference did not choose, and the mean gap; else the widest gap."""
    if config(config_name).get("n_routed_experts"):
        return {"served_tokens": 8, "route_margin": 0.01,
                "logit_gap_max_clear": limit, "logit_gap_mean": limit / 4,
                "expert_miss_share": missed}
    return {"served_tokens": 8, "logit_gap_max": limit}


def cell(config_name: str, loop: str = "open", trace_metrics=None,
         limit: float = 1e-3, **mix_extra) -> Cell:
    b = bench.load_json(bench.ROOT / "BENCHMARK.json")
    e2e = [m for m in b["end_to_end"]]
    per = [m for m in b["per_layer"]
           if trace_metrics is None or m["name"] in trace_metrics]
    return Cell(name="smoke", chips=1, cfg=config(config_name),
                mix=mix(loop, **mix_extra),
                limits=limits(config_name, limit),
                end_to_end=copy.deepcopy(e2e), per_layer=copy.deepcopy(per))


class StepClock:
    """A window clock for the CPU tests: each reading advances it by
    ``step`` seconds and a sleep by its length, so a window holds the same
    work however busy the machine is."""

    def __init__(self, step: float = 1e-3):
        self.now, self.step = 0.0, step

    def __call__(self) -> float:
        self.now += self.step
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += seconds
