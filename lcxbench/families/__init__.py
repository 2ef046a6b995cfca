"""Model families: a configuration's weight layout, its layer kinds and its
operation counts, found by the configuration file's ``family`` key.

A family is a module ``lcxbench/families/<family>.py`` (or any importable
module, where the key holds a dotted name) that gives:

- ``leaves(cfg)``: every weight as ``(path, shape, kind, std)``, in the
  order ``weights.draw`` draws them (``weights.py`` names the kinds);
- ``fields``: the file's keys -> the program's ``ModelConfig`` fields,
  beside ``model.FIELDS``;
- ``program``: keys -> what the program computes, beside
  ``model.PROGRAM``; a file that states otherwise names the key under
  ``departures`` or is refused;
- ``layer_kinds(cfg)``: ``(mixer, ffn)`` of each layer, in the program's
  words (``"attn"``, ``"mla"``, ``"mamba"``; ``"dense"``, ``"moe"``);
  ``model.check_kinds`` holds it to the program's layer plan;
- ``prefill_flops(cfg, n)`` and ``decode_flops(cfg, lengths)``: the
  operations of one prompt of ``n`` tokens and of one decode step of
  caches holding ``lengths`` tokens (``counts.py`` says what counts);
- ``routed_experts(cfg)``: the number of routed experts, 0 without.

A file without the key is of the family ``decoder``.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

DEFAULT = "decoder"


def of(cfg: Dict) -> ModuleType:
    """The family module of the configuration file ``cfg``."""
    name = cfg.get("family", DEFAULT)
    return importlib.import_module(name if "." in name
                                   else f"{__name__}.{name}")
