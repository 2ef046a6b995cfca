"""Mixture-of-Experts with expert-parallel dispatch over LCX.

The port of ``repro/models/moe.py``.  Backends (``cfg.moe_backend``):

- ``dense``: loop-over-experts masked reference (exact, O(E·T·d·f)
  compute; the correctness oracle of the twins);
- ``sort``: sort-based capacity dispatch on one device (stable sort by
  expert id, position within the expert from the group starts, capacity
  drop), the local building block of the expert-parallel path;
- ``lcx``: expert parallelism over the active mesh
  (``parallel.sharding``); with no mesh it takes the sort path, as the
  reference does.  Under a mesh, :func:`moe_apply` takes the reference's
  branches: a prefill splits its tokens over (data..., model) ranks and
  runs :func:`_moe_ep` (sequence-sharded when ``S % ep == 0``,
  token-sliced and padded otherwise), whose per-rank body
  :func:`_moe_ep_shard` dispatches rank-stacked tokens with LCX's
  ``all_to_all_x``; a decode step runs :func:`_moe_resident_decode` when
  the experts are resident on the joint (model, data...) ranks
  (:func:`resident_plan`), else the sort path over streamed chunks of
  experts.  Both decode branches route all B tokens together with
  ``capacity(cfg, B)``, as the reference's mesh paths do.

Routers: ``softmax`` (standard top-k) and ``sigmoid`` (DeepSeek-V3 style
with top-k normalisation).  The aux loss is the Switch load-balancing
loss.  ``kernel_fn`` is the ``"moe_gmm"`` hook of ``kernels.ops``: with it
the expert FFN's three products run the grouped-matmul kernel, without it
the reference's einsums.

Dispatch and combine keep fixed shapes and never wait for the device:
sizes by ``scatter_add_``, the capacity drop as an extra last row of the
buffer that is cut off, and combine's scatter-add as a gather of each
token's k contributions and one sum over them, so the result does not
depend on the order of atomic adds.
"""
from __future__ import annotations

import contextlib

import math
from typing import Any, Callable, Optional, Tuple

import torch

from .. import core as lcx
from ..core import ranks
from ..parallel.sharding import (active_mesh, active_rules, dp_axes,
                                 ep_axis_name)
from .common import PyTree, _normal, dense, dense_init, swiglu

KernelFn = Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _expert_stack(gen: torch.Generator, E: int, d_in: int, d_out: int,
                  dtype: torch.dtype, device: torch.device) -> PyTree:
    return {"w": _normal(gen, (E, d_in, d_out), 1.0 / math.sqrt(d_in),
                         dtype, device)}


def moe_init(gen: torch.Generator, cfg: Any, device: torch.device) -> PyTree:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    kw = dict(dtype=cfg.param_dtype, device=device)
    p = {"router": dense_init(gen, d, E, dtype=torch.float32, device=device),
         "w_gate": _expert_stack(gen, E, d, f, **kw),
         "w_up": _expert_stack(gen, E, d, f, **kw),
         "w_down": _expert_stack(gen, E, f, d, **kw)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.moe_d_ff
        p["shared_gate"] = dense_init(gen, d, fs, **kw)
        p["shared_up"] = dense_init(gen, d, fs, **kw)
        p["shared_down"] = dense_init(gen, fs, d, **kw)
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def route(cfg: Any, router_p: PyTree, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d] -> (ids [T, k] int64, weights [T, k] f32, aux loss [])."""
    logits = x.float() @ router_p["w"].float()                # [T, E]
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    # top k with ties to the lower expert id, as lax.top_k breaks them
    # (torch.topk does not: tied scores, such as a zero padding row's,
    # would choose other experts)
    w, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_per_tok
    w, ids = w[..., :k], ids[..., :k]
    if cfg.router_norm_topk:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load-balance aux: E * sum_e f_e * P_e
    E = cfg.n_experts
    probs = (scores if cfg.router_type != "sigmoid"
             else torch.softmax(logits, dim=-1))
    f = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), dtype=torch.float32,
                                       device=x.device))
    f = f / max(ids.numel(), 1)
    aux = E * torch.sum(f * probs.mean(0))
    return ids, w, aux


# ---------------------------------------------------------------------------
# expert FFN on a capacity buffer  xb [E_loc, Cb, d]
# ---------------------------------------------------------------------------
def _expert_ffn(p: PyTree, xb: torch.Tensor, e_start: int, e_count: int,
                kernel_fn: KernelFn = None) -> torch.Tensor:
    wg, wu, wd = (p[k]["w"].narrow(0, e_start, e_count).to(xb.dtype)
                  for k in ("w_gate", "w_up", "w_down"))
    if kernel_fn is not None:
        return kernel_fn(swiglu(kernel_fn(xb, wg), kernel_fn(xb, wu)), wd)
    g = torch.einsum("ecd,edf->ecf", xb, wg)
    u = torch.einsum("ecd,edf->ecf", xb, wu)
    return torch.einsum("ecf,efd->ecd", swiglu(g, u), wd)


# ---------------------------------------------------------------------------
# sort-based capacity dispatch (local)
# ---------------------------------------------------------------------------
def capacity(cfg: Any, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.n_experts_per_tok / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)        # multiple of 8, as the reference


def decode_capacity(cfg: Any, n_slots: int) -> int:
    """Capacity of a decode step that routes ``n_slots`` one-token
    sequences in one call.  The reference's engine routes each slot alone
    (T = 1, capacity 8), so it drops no decode token; here every slot that
    chose an expert must fit, and since a token's top-k experts are
    distinct, an expert gets at most ``n_slots`` rows."""
    return max(capacity(cfg, n_slots), -(-n_slots // 8) * 8)


def dispatch(x_flat: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
             E: int, C: int) -> Tuple[torch.Tensor, PyTree]:
    """x_flat [T, d]; ids/w [T, k] -> (buf [E, C, d], combine info).

    Stable sort by expert id; position within the expert from the group
    starts; tokens beyond capacity go to row E*C of an [E*C + 1, d]
    buffer, which is cut off (the reference's scatter with
    ``mode="drop"``)."""
    T, k = ids.shape
    d = x_flat.shape[-1]
    flat_ids = ids.reshape(-1)                       # [T*k]
    order = torch.argsort(flat_ids, stable=True)
    ids_s = flat_ids[order]
    tok_s = order // k
    sizes = torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(T * k, device=ids.device) - starts[ids_s]
    slot = torch.where(pos < C, ids_s * C + pos,
                       torch.full_like(pos, E * C))  # E*C = drop bucket
    buf = x_flat.new_zeros((E * C + 1, d))
    buf[slot] = x_flat[tok_s]
    info = {"slot": slot, "tok": tok_s,
            "w": w.reshape(-1)[order].float(), "T": T}
    return buf[:E * C].reshape(E, C, d), info


def combine(yb: torch.Tensor, info: PyTree, d: int) -> torch.Tensor:
    """yb [E, C, d] -> y [T, d]: each token's k weighted rows gathered
    (in ascending expert id) and summed by one reduction over k."""
    yb_flat = yb.reshape(-1, d)
    n = yb_flat.shape[0]
    slot = info["slot"]
    T = info["T"]
    gathered = yb_flat[slot.clamp(max=n - 1)]
    gathered = torch.where((slot < n)[:, None], gathered,
                           torch.zeros((), dtype=yb.dtype, device=yb.device))
    contrib = gathered * info["w"][:, None].to(yb.dtype)   # [T*k, d]
    # the rows of each token, in sorted-list order
    rows = torch.argsort(info["tok"], stable=True).reshape(T, -1)
    return contrib[rows].sum(1)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
def _moe_dense(cfg: Any, p: PyTree, x_flat: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked loop-over-experts reference (the einsums, no kernel)."""
    ids, w, aux = route(cfg, p["router"], x_flat)
    y = torch.zeros_like(x_flat)
    for e in range(cfg.n_experts):
        gate = ((ids == e).float() * w).sum(-1).to(x_flat.dtype)  # [T]
        he = _expert_ffn(p, x_flat[None], e, 1)[0]
        y = y + he * gate[:, None]
    return y, aux


def _moe_sort_local(cfg: Any, p: PyTree, x_flat: torch.Tensor,
                    stream_chunks: int = 0, kernel_fn: KernelFn = None,
                    decode: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode``: each row of ``x_flat`` is one sequence's decode token,
    routed as if alone (:func:`decode_capacity`)."""
    ids, w, aux = route(cfg, p["router"], x_flat)
    T = x_flat.shape[0]
    C = decode_capacity(cfg, T) if decode else capacity(cfg, T)
    buf, info = dispatch(x_flat, ids, w, cfg.n_experts, C)
    if stream_chunks > 1 and cfg.n_experts % stream_chunks == 0:
        # the reference's weight-streamed decode: the expert FFN over
        # E / stream_chunks experts at a time (a lax.scan there)
        ck = cfg.n_experts // stream_chunks
        yb = torch.cat([_expert_ffn(p, buf[i * ck:(i + 1) * ck], i * ck, ck,
                                    kernel_fn)
                        for i in range(stream_chunks)])
    else:
        yb = _expert_ffn(p, buf, 0, cfg.n_experts, kernel_fn)
    return combine(yb, info, x_flat.shape[-1]), aux


def _moe_ep_shard(cfg: Any, p: PyTree, x: torch.Tensor, ep_axis: str,
                  a2a_backend: str, kernel_fn: KernelFn = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's per-rank body of expert parallelism, on rank-stacked
    tokens: ``x [ep, T_loc, d]`` (rank r's tokens are ``x[r]``) under
    ``ranks.bind_axis(ep_axis, ep)``.  Returns (y [ep, T_loc, d], aux
    [ep]), each rank's as the reference's ``_moe_ep_shard`` gives it.

    Rank r owns experts ``r*E_loc .. (r+1)*E_loc - 1``: the full stacks
    ``[E, ...]`` viewed as ``[ep, E_loc, ...]``.  Each rank routes and
    dispatches its own tokens; an LCX all-to-all on a private runtime
    sends every capacity row to its expert's rank; the expert FFN of all
    ranks, ``[ep, E_loc, ep*C, d]``, is one product over ``[E, ep*C, d]``
    (one kernel launch per projection); a second all-to-all brings the
    rows back and each rank combines its own."""
    y, aux = _moe_ep_groups(cfg, p, x[None], ep_axis, a2a_backend,
                            kernel_fn)
    return y[0], aux[0]


def _moe_ep_groups(cfg: Any, p: PyTree, x: torch.Tensor, ep_axis: str,
                   a2a_backend: str, kernel_fn: KernelFn = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_moe_ep_shard` for ``G`` independent groups of ranks at once:
    ``x [G, ep, T_loc, d]`` (the data-parallel groups of a mesh, each an
    expert-parallel ring of ``ep`` ranks) -> (y [G, ep, T_loc, d], aux
    [G, ep]).  Each group's all-to-alls stay within it; the expert FFN of
    every group and rank is one product over ``[E, G*ep*C, d]``."""
    ep = ranks.axis_size(ep_axis)
    if x.dim() != 4 or x.shape[1] != ep:
        raise ValueError(f"rank-stacked x has shape {tuple(x.shape)}, axis "
                         f"{ep_axis!r} has {ep} ranks")
    E = cfg.n_experts
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} ranks")
    G, E_loc, d = x.shape[0], E // ep, x.shape[-1]
    C = capacity(cfg, x.shape[2])
    infos, auxes, sent = [], [], []
    # Private runtime + isolated device per a2a region: the MoE layer's
    # traffic never touches (or requires) the global default runtime.
    rt = lcx.Runtime(name="moe-ep")
    dev = rt.device(axis=ep_axis)
    for g in range(G):
        bufs = []
        for r in range(ep):
            ids, w, aux = route(cfg, p["router"], x[g, r])
            buf, info = dispatch(x[g, r], ids, w, E, C)   # [E, C, d]
            bufs.append(buf.reshape(E * C, d))
            infos.append(info)
            auxes.append(aux)
        sent.append(lcx.all_to_all_x(torch.stack(bufs)).device(dev)
                    .backend(a2a_backend)())
    # rank r's rows grouped by source rank: [G, ep, ep, E_loc, C, d] ->
    # [ep, E_loc, G, ep*C, d], i.e. [E, G*ep*C, d] in global expert order
    xb = torch.stack(sent).reshape(G, ep, ep, E_loc, C, d) \
        .permute(1, 3, 0, 2, 4, 5).reshape(E, G * ep * C, d)
    yb = _expert_ffn(p, xb, 0, E, kernel_fn)
    back = yb.reshape(ep, E_loc, G, ep, C, d).permute(2, 0, 3, 1, 4, 5) \
        .reshape(G, ep, E * C, d)
    ys = []
    for g in range(G):
        y_all = lcx.all_to_all_x(back[g]).device(dev) \
            .backend(a2a_backend)()
        ys.append(torch.stack([
            combine(y_all[r].reshape(E, C, d), infos[g * ep + r], d)
            for r in range(ep)]))
    return torch.stack(ys), torch.stack(auxes).reshape(G, ep)


def _moe_ep(cfg: Any, p: PyTree, x: torch.Tensor, mesh: Any,
            kernel_fn: KernelFn = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the mesh: x [B, S, d] -> (y [B*S, d], aux).

    The batch splits over the longest prefix of the data axes that
    divides it, one group of ``ep`` expert-parallel ranks for each data
    rank, and the split changes values: each rank's capacity counts its
    own tokens.  Tokens are sequence-sharded over the ``model`` axis when
    S divides, else each group's tokens are padded to a multiple of
    ``ep`` and sliced, and the slices joined back (the reference's psum
    of disjoint slices).  The aux loss is the mean over the first
    group's ranks, with the gradient of the mean over every rank: the
    reference's region returns it as replicated, which reads data rank
    0's value, and its transpose hands every rank the cotangent."""
    ep_ax = ep_axis_name()
    ep = mesh.shape[ep_ax]
    b, s, d = x.shape
    dp, dp_names = 1, []
    for a in dp_axes(mesh):
        if b % (dp * mesh.shape[a]):
            break
        dp *= mesh.shape[a]
        dp_names.append(a)
    bl = b // dp
    backend = cfg_a2a_backend(cfg)
    with contextlib.ExitStack() as region:
        # the groups are ranks of the reference's region along dp_names
        for a in dp_names:
            region.enter_context(ranks.bind_axis(a, mesh.shape[a]))
        region.enter_context(ranks.bind_axis(ep_ax, ep))
        if s % ep == 0:
            xs = x.reshape(dp, bl, ep, s // ep, d).transpose(1, 2) \
                .reshape(dp, ep, bl * (s // ep), d)
            y, aux = _moe_ep_groups(cfg, p, xs, ep_ax, backend, kernel_fn)
            y = y.reshape(dp, ep, bl, s // ep, d).transpose(1, 2)
            return y.reshape(b * s, d), _replicated_aux(aux)
        T = bl * s
        Tp = -(-T // ep) * ep
        xp = torch.nn.functional.pad(x.reshape(dp, T, d),
                                     (0, 0, 0, Tp - T))
        y, aux = _moe_ep_groups(cfg, p, xp.reshape(dp, ep, Tp // ep, d),
                                ep_ax, backend, kernel_fn)
        return (y.reshape(dp, Tp, d)[:, :T].reshape(b * s, d),
                _replicated_aux(aux))


def _replicated_aux(aux: torch.Tensor) -> torch.Tensor:
    """aux [G, ep] -> the first group's mean, differentiated as the mean
    of all G * ep ranks' (the value plus an exact zero that carries the
    gradient)."""
    every = aux.mean()
    return aux[0].mean().detach() + (every - every.detach())


def _resident_ok(cfg: Any, mesh: Any) -> bool:
    """Resident-expert decode needs (i) the experts rule to shard over
    the joint axes (set by ``launch.steps.decode_rules``), (ii) the
    resident slab to fit the budget."""
    axes = resident_plan(cfg, mesh)
    return axes is not None \
        and tuple(active_rules().get("experts", ())) == axes


def moe_apply(cfg: Any, p: PyTree, x: torch.Tensor,
              kernel_fn: KernelFn = None, decode: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss scalar).

    ``lcx`` under an active mesh takes the reference's mesh branches: at
    S = 1 the resident-expert decode (:func:`_resident_ok`) or the sort
    path over ``min(16, E)`` streamed chunks of experts, both at
    ``capacity(cfg, B)``; otherwise :func:`_moe_ep` when the ``model``
    axis has more than one rank and splits the experts.  Else, as the
    reference with no mesh: ``dense`` stays dense (the oracle, which runs
    no kernel), every other backend takes the sort path.  ``decode`` (x
    [B, 1, d], one token for each of B sequences): the sort path with no
    mesh routes each token as the reference's per-slot decode does, with
    :func:`decode_capacity`."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    mesh = active_mesh()
    ep_ax = ep_axis_name()
    lcx_mesh = cfg.moe_backend == "lcx" and mesh is not None
    if lcx_mesh and s == 1 and _resident_ok(cfg, mesh):
        # decode with the experts resident on the joint ranks: no weight
        # streaming at all
        y, aux = _moe_resident_decode(cfg, p, x_flat, mesh, kernel_fn)
    elif lcx_mesh and s == 1:
        # decode fallback: the expert FFN over streamed chunks of experts
        y, aux = _moe_sort_local(cfg, p, x_flat,
                                 stream_chunks=min(16, cfg.n_experts),
                                 kernel_fn=kernel_fn)
    elif lcx_mesh and ep_ax in mesh.axis_names \
            and mesh.shape[ep_ax] > 1 \
            and cfg.n_experts % mesh.shape[ep_ax] == 0:
        y, aux = _moe_ep(cfg, p, x, mesh, kernel_fn)
    elif cfg.moe_backend == "dense":
        y, aux = _moe_dense(cfg, p, x_flat)
    else:
        y, aux = _moe_sort_local(cfg, p, x_flat, kernel_fn=kernel_fn,
                                 decode=decode)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        g = dense(p["shared_gate"], x)
        u = dense(p["shared_up"], x)
        y = y + dense(p["shared_down"], swiglu(g, u))
    return y, aux


def cfg_a2a_backend(cfg: Any) -> str:
    """LCX a2a lowering: 'native' (one permutation of the rank dim) or
    'pairwise' (n - 1 LCX puts).  Tunable per config."""
    return getattr(cfg, "moe_a2a", "native")


# ---------------------------------------------------------------------------
# resident-expert decode
# ---------------------------------------------------------------------------
RESIDENT_BUDGET_BYTES = 6 * 1024 ** 3     # device share for resident experts


def resident_axes(mesh: Any, E: int) -> Tuple[Tuple[str, ...], int]:
    """Longest (model, data..., pod) prefix whose product divides E: the
    joint axes the expert weights shard over so that they stay resident
    for decode (no FSDP weight streaming).  DeepSeek-V3's 256 experts
    over 256 ranks: one resident expert a rank."""
    axes = []
    prod = 1
    # model first, then data, then pod: on the multi-pod mesh 256 experts
    # land on (model, data) and stay replicated across pods
    for a in ("model", *reversed(dp_axes(mesh))):
        if a in mesh.shape and E % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
        else:
            break
    return tuple(axes), prod


def resident_plan(cfg: Any, mesh: Any) -> Optional[Tuple[str, ...]]:
    """Axes for the resident-expert decode, or None when a rank's
    resident slab would not fit the budget (Jamba's 16 fat experts over
    256 ranks, 1.2 GiB x 36 layers: stream instead)."""
    if not cfg.n_experts:
        return None
    axes, n = resident_axes(mesh, cfg.n_experts)
    if n <= 1:
        return None
    n_moe_layers = sum(1 for spec in cfg.layer_plan() if spec.ffn == "moe")
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    per_dev = (cfg.n_experts // n) * 3 * cfg.d_model * cfg.moe_d_ff \
        * itemsize * n_moe_layers
    if per_dev > RESIDENT_BUDGET_BYTES:
        return None
    return axes


def _moe_resident_decode(cfg: Any, p: PyTree, x_flat: torch.Tensor,
                         mesh: Any, kernel_fn: KernelFn = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode MoE with resident experts: the tokens are replicated (tiny
    at decode), so every rank routes all T of them alike with
    ``capacity(cfg, T)``; rank r (numbered row-major over
    :func:`resident_axes`) runs the FFN on the capacity rows of its
    ``E_loc`` experts with its resident weights, and the rows come back
    by the reference's psum of disjoint slices.  With every rank on one
    card the owner ranks' slices ``[E_loc, C, d]`` tile the capacity
    buffer ``[E, C, d]`` in expert order, so the region is the sort path
    at ``capacity(cfg, T)``: every rank's FFN in one product (one kernel
    launch per projection)."""
    return _moe_sort_local(cfg, p, x_flat, kernel_fn=kernel_fn)
