"""Parallel execution on rank-stacked meshes (the port of
``repro/parallel/``).

The rank model for a mesh:

- **The mesh** is names and sizes with no devices:
  ``Mesh(shape=(2, 4), axis_names=("data", "model"))`` has
  ``.shape[a]`` and ``.axis_names``, as the reference reads a JAX mesh.
  Every rank lives on the one card.  ``abstract_mesh`` and
  ``launch/mesh.py``'s ``make_mesh`` / ``make_production_mesh`` /
  ``make_host_mesh`` build one.
- **Automatic sharding changes layout, not values.**  The reference's
  GSPMD constraints and shardings decide where data lives; here
  :func:`constrain` returns its input unchanged, and
  :func:`logical_spec` / :func:`param_shardings` give the reference's
  specs as data (:class:`PartitionSpec`, :class:`NamedSharding`).
- **Every ``shard_map`` region of the reference is a function on
  rank-stacked views.**  It views the global tensors as ``[n_ranks, ...]``
  along the axes over which the region communicates, with no copy where
  the layout allows it (the KV or latent cache along its sequence dim,
  the expert stack along ``E``, the stages along ``pipe``), binds those
  axes with ``ranks.bind_axis``, and runs the per-rank body on all ranks
  at once, batched over dim 0, or in a loop over ranks where the body is
  a Python LCX program.  Ranks of several axes are numbered row-major in
  the order the region lists them.  Axes that only split the batch and
  carry no traffic in a region are left unstacked, except where the
  split changes values: the expert-parallel MoE's capacity counts each
  rank's own tokens, so its data-axis split is honoured.

The mesh branches live where the reference has them: the
context-parallel decode in ``models/attention.py`` and ``models/mla.py``,
expert parallelism and the resident-expert decode in ``models/moe.py``,
GPipe in :mod:`.pipeline` and :mod:`.pp`, ``compressed_psum`` in
``optim/compression.py``, and the trainer's mesh and ``remesh`` in
``runtime/trainer.py``.
"""
from .sharding import (DEFAULT_RULES, Mesh, NamedSharding, PartitionSpec,
                       abstract_mesh, active_mesh, active_rules, constrain,
                       dp_axes, ep_axis_name, logical_spec, param_shardings,
                       set_active_mesh, set_rules, use_mesh)
from . import pipeline  # noqa: F401

__all__ = [
    "DEFAULT_RULES", "Mesh", "NamedSharding", "PartitionSpec",
    "abstract_mesh", "active_mesh", "active_rules", "constrain", "dp_axes",
    "ep_axis_name", "logical_spec", "param_shardings", "set_active_mesh",
    "set_rules", "use_mesh", "pipeline",
]
