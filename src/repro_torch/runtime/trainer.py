"""The Trainer: the train step, microbatched gradient accumulation (f32
or int8 + error feedback), checkpoint/restart and failure recovery.

The port of ``repro/runtime/trainer.py`` on one device (``device``,
default ``"cuda"``).  Gradients come from autograd through
:func:`repro_torch.models.loss_fn`; the optimizer updates the parameters
in place.  With no mesh one batch per step is built on the host and
moved to the device.  With ``mesh`` (a
:class:`~repro_torch.parallel.Mesh`, every rank on the card) it follows
the reference's mesh branch: the mesh is made active, so the models take
their mesh paths; the params, the optimizer state and the batch get
their :class:`~repro_torch.parallel.NamedSharding` trees from the
logical dims, and a prefetching :class:`~repro_torch.data.DataLoader`
feeds the steps.  The shardings change layout, not values, so a meshed
run of a model with no mesh branch gives the unmeshed run's losses.
:meth:`Trainer.remesh` moves the live state to a new mesh (shrink after a
node loss, grow on recovery) and rebuilds the step and the loader.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..data import DataLoader, SyntheticLMDataset, to_device
from ..device import DeviceLike, resolve_device
from ..models import abstract_init, init_model, loss_fn
from ..models.common import PyTree, tree_leaves, tree_map, tree_unflatten
from ..optim import (AdamWState, CompressedAccumulator, adamw_init,
                     adamw_update, clip_by_global_norm, cosine_schedule)
from ..parallel.sharding import (Mesh, NamedSharding, P, logical_spec,
                                 param_shardings, set_active_mesh)
from .fault import (FailureInjector, NodeFailure, StragglerMonitor,
                    elastic_reshard)


@dataclasses.dataclass
class TrainConfig:
    """The reference's fields.  ``donate`` is the reference's choice to
    donate the params and the optimizer state to the :class:`Trainer`'s
    step (``donate_argnums=(0, 1)``): with ``True`` the step updates the
    tensors it is given in place; with ``False`` it updates copies, so
    the tensors it was given stay as they were (one more copy of the
    params and the moments live during a step)."""
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    grad_accum: int = 1
    compressed_accum: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0
    seq_len: int = 512
    global_batch: int = 8
    straggler_threshold: float = 2.0
    straggler_patience: int = 3
    donate: bool = True


def make_train_step(cfg: Any, tcfg: TrainConfig,
                    lr_fn: Callable[[torch.Tensor], torch.Tensor],
                    kernels: Optional[Dict[str, Any]] = None):
    """Train step: (params, opt, batch) -> (params, opt, metrics), the
    params and moments updated in place, the metrics 0-d tensors on the
    device."""
    accum = max(tcfg.grad_accum, 1)

    def value_and_grad(params: PyTree, batch: Dict[str, torch.Tensor]):
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        loss, metrics = loss_fn(cfg, params, batch, kernels=kernels)
        # a leaf the loss does not reach gets zeros, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, tree_unflatten(params, list(grads))

    def micro(batch: Dict[str, torch.Tensor], i: int):
        return {k: t[i * (t.shape[0] // accum):(i + 1) * (t.shape[0]
                                                      // accum)]
                for k, t in batch.items()}

    def step(params: PyTree, opt: AdamWState,
             batch: Dict[str, torch.Tensor]):
        if accum == 1:
            metrics, grads = value_and_grad(params, batch)
        else:
            # microbatches along dim 0; the accumulator is f32, or int8 +
            # error feedback with tcfg.compressed_accum
            metrics = None
            if tcfg.compressed_accum:
                acc = CompressedAccumulator.init(params)
            else:
                acc = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(accum):
                m, g = value_and_grad(params, micro(batch, i))
                if tcfg.compressed_accum:
                    acc = CompressedAccumulator.add(acc, g)
                else:
                    acc = tree_map(lambda a, b: a + b.float(), acc, g)
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
                del g
            grads = (CompressedAccumulator.value(acc, accum)
                     if tcfg.compressed_accum
                     else tree_map(lambda a: a / accum, acc))
            metrics = {k: v / accum for k, v in metrics.items()}
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr = lr_fn(opt.step)
        params, opt = adamw_update(params, grads, opt, lr=lr,
                                   weight_decay=tcfg.weight_decay)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt, metrics

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg: Any, tcfg: TrainConfig,
                 mesh: Optional[Mesh] = None, *,
                 device: DeviceLike = None,
                 kernels: Optional[Dict[str, Any]] = None,
                 failure_injector: Optional[FailureInjector] = None,
                 lcx_runtime: Optional[Any] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.kernels = kernels
        self.injector = failure_injector
        self.lcx_runtime = lcx_runtime
        if (self.injector is not None and lcx_runtime is not None
                and self.injector.runtime is None):
            self.injector.runtime = lcx_runtime
        self.monitor = StragglerMonitor(tcfg.straggler_threshold,
                                        tcfg.straggler_patience)
        self.ckpt = (AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
                     if tcfg.ckpt_dir else None)
        self.step_count = 0
        self.metrics_log: list = []
        self._build()

    # -- construction -------------------------------------------------------
    def _build(self) -> None:
        cfg, tcfg = self.cfg, self.tcfg
        set_active_mesh(self.mesh)
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.params = init_model(gen, cfg, device=self.device)
        self.dims = abstract_init(cfg)[1]
        self._set_shardings()
        self.opt = adamw_init(self.params, cfg.opt_dtype)
        self.lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
        self._step_fn = self._compile_step()
        self.dataset = SyntheticLMDataset(
            cfg.vocab, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed,
            frontend_len=cfg.frontend_len, frontend_dim=cfg.d_model,
            family=cfg.family)
        self.loader = self._make_loader(start_step=0)

    def _compile_step(self) -> Callable[..., Any]:
        step = make_train_step(self.cfg, self.tcfg, self.lr_fn,
                               self.kernels)
        if self.tcfg.donate:
            return step

        def undonated(params: PyTree, opt: AdamWState,
                      batch: Dict[str, torch.Tensor]):
            copy = lambda tree: tree_map(  # noqa: E731
                lambda t: t.detach().clone(), tree)
            return step(copy(params), AdamWState(
                step=opt.step, m=copy(opt.m), v=copy(opt.v)), batch)
        return undonated

    def _set_shardings(self) -> None:
        """The params' and the optimizer state's sharding trees on the
        current mesh (None with no mesh)."""
        if self.mesh is None:
            self.param_sharding = self.opt_sharding = None
            return
        self.param_sharding = param_shardings(self.dims, self.params,
                                              self.mesh)
        self.opt_sharding = AdamWState(
            step=NamedSharding(self.mesh, P()), m=self.param_sharding,
            v=self.param_sharding)

    def batch_sharding(self) -> Dict[str, NamedSharding]:
        if self.mesh is None:
            return {}
        spec3 = NamedSharding(self.mesh, logical_spec(
            ("batch", None, None), None, self.mesh))
        spec2 = NamedSharding(self.mesh, logical_spec(
            ("batch", None), None, self.mesh))
        out = {"tokens": spec2, "labels": spec2}
        if self.cfg.family == "audio" or self.cfg.frontend_len:
            out["frontend"] = spec3
        return out

    def _make_loader(self, start_step: int) -> Optional[DataLoader]:
        """A prefetching loader on a mesh, as the reference builds one
        there (its batch specs are layouts over ranks on this card)."""
        if self.mesh is None:
            return None
        return DataLoader(self.dataset, self.batch_sharding(),
                          start_step=start_step, device=self.device)

    def _host_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return to_device(self.dataset.batch(step), self.device)

    # -- checkpoint / restore ------------------------------------------------
    def save(self, blocking: bool = False) -> None:
        if self.ckpt is None:
            return
        state = {"params": self.params, "opt": self.opt}
        self.ckpt.save(self.step_count, state,
                       extra={"step_count": self.step_count})
        if blocking:
            self.ckpt.wait()

    def restore(self) -> bool:
        if self.tcfg.ckpt_dir is None:
            return False
        if self.ckpt is not None:
            self.ckpt.wait()
        if latest_step(self.tcfg.ckpt_dir) is None:
            return False
        target = {"params": self.params, "opt": self.opt}
        shardings = None
        if self.param_sharding is not None:
            shardings = {"params": self.param_sharding,
                         "opt": self.opt_sharding}
        state, step, extra = restore_checkpoint(
            self.tcfg.ckpt_dir, target, shardings=shardings,
            device=self.device)
        self.params, self.opt = state["params"], state["opt"]
        self.step_count = extra.get("step_count", step)
        if self.loader is not None:
            self.loader.close()
            self.loader = self._make_loader(start_step=self.step_count)
        return True

    # -- elastic remesh -----------------------------------------------------
    def remesh(self, new_mesh: Optional[Mesh]) -> None:
        """Move live state to a new mesh (shrink after failure or grow on
        recovery), rebuild the step and the loader."""
        if self.ckpt is not None:
            self.ckpt.wait()
        set_active_mesh(new_mesh)
        self.mesh = new_mesh
        self._set_shardings()
        if new_mesh is not None:
            self.params = elastic_reshard(self.params, self.param_sharding)
            self.opt = elastic_reshard(self.opt, self.opt_sharding)
        self._step_fn = self._compile_step()
        if self.loader is not None:
            self.loader.close()
        self.loader = self._make_loader(start_step=self.step_count)

    # -- throughput accounting -------------------------------------------
    def _flops_per_step(self) -> float:
        """6·N_active·tokens, the MFU yardstick."""
        if not hasattr(self, "_mf_cache"):
            from ..analysis.roofline import model_flops
            proto, _ = abstract_init(self.cfg)
            self._mf_cache = model_flops(
                self.cfg, proto, "train", self.tcfg.seq_len,
                self.tcfg.global_batch)
        return self._mf_cache

    def achieved_flops(self, dt: float) -> float:
        return self._flops_per_step() / max(dt, 1e-9)

    # -- run loop ------------------------------------------------------------
    def run(self, n_steps: int, max_failures: int = 8) -> Dict[str, Any]:
        failures = 0
        end = self.step_count + n_steps
        # step-0 checkpoint: recovery is possible from the very first
        # step (a failure before any commit would otherwise be fatal)
        if self.ckpt is not None and latest_step(self.tcfg.ckpt_dir) is None:
            self.save(blocking=True)
        while self.step_count < end:
            try:
                self._run_until(end)
            except NodeFailure as e:
                failures += 1
                if failures > max_failures:
                    raise
                # recovery: restore last committed state and continue
                restored = self.restore()
                if not restored:
                    raise RuntimeError(
                        "node failure before any checkpoint") from e
        if self.ckpt is not None:
            self.save(blocking=True)
        return {"final_step": self.step_count,
                "failures": failures,
                "straggler_events": list(self.monitor.events),
                "metrics": self.metrics_log[-1] if self.metrics_log else {}}

    def _run_until(self, end: int) -> None:
        while self.step_count < end:
            if self.injector is not None:
                self.injector.check(self.step_count)
            if self.loader is not None:
                _, batch = next(self.loader)
            else:
                batch = self._host_batch(self.step_count)
            _sync(self.device)
            t0 = time.perf_counter()
            self.params, self.opt, metrics = self._step_fn(
                self.params, self.opt, batch)
            _sync(self.device)
            dt = time.perf_counter() - t0
            self.step_count += 1
            verdict = self.monitor.observe(self.step_count, dt)
            if self.step_count % self.tcfg.log_every == 0 \
                    or self.step_count == end:
                self.metrics_log.append(
                    {"step": self.step_count,
                     **{k: float(v) for k, v in metrics.items()},
                     "dt": dt, "straggler": verdict,
                     "tokens_per_s": self.tcfg.seq_len
                     * self.tcfg.global_batch / dt,
                     "model_flops_per_s": self.achieved_flops(dt)})
            if self.tcfg.ckpt_dir and \
                    self.step_count % self.tcfg.ckpt_every == 0:
                self.save()
