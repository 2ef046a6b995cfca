"""Deterministic synthetic token pipeline.

The port of ``repro/data/pipeline.py``.  Every batch is a pure function
of ``(seed, step)``, and each row of ``(seed, step, row)``, so a worker
restarted after a failure regenerates exactly the same data: the
property the checkpoint/restart path relies on.  The batches are numpy
arrays bit-equal to the reference's.  :class:`DataLoader` prefetches them
on a thread and moves them to one device, where the reference's lays out
each device's shard with the trainer's shardings.

The "dataset" is a Zipf-ish token stream with a short Markov flavour so
the loss actually decreases during the example runs (pure uniform noise
has constant optimal loss).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class SyntheticLMDataset:
    """Stateless: ``batch(step)`` -> dict of numpy arrays."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frontend_len: int = 0,
                 frontend_dim: int = 0, family: str = "dense") -> None:
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.frontend_len = frontend_len
        self.frontend_dim = frontend_dim
        self.family = family
        # fixed Markov transition "structure" derived from the seed
        rng = np.random.default_rng(seed)
        self._shift = rng.integers(1, max(vocab - 1, 2))

    def _tokens(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the global batch at ``step``.  Each ROW is a
        pure function of (seed, step, global_row) so any worker
        regenerating any slice gets bit-identical data — the
        restart/reshard invariant."""
        rows = []
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r]))
            # Zipf-distributed tokens with a deterministic Markov overlay
            z = rng.zipf(1.3, size=self.seq_len)
            base = (z % self.vocab).astype(np.int32)
            flip = rng.random(self.seq_len) < 0.5
            markov = (np.roll(base, 1) + self._shift) % self.vocab
            rows.append(np.where(flip, markov, base).astype(np.int32))
        return np.stack(rows)

    def batch(self, step: int, lo: int = 0, hi: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        hi = self.global_batch if hi is None else hi
        toks = self._tokens(step, lo, hi)
        out: Dict[str, np.ndarray] = {
            "tokens": toks,
            "labels": np.roll(toks, -1, axis=1),
        }
        flen = self.seq_len if self.family == "audio" else \
            self.frontend_len
        if self.family == "audio" or self.frontend_len:
            fe = []
            for r in range(lo, hi):
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, step, r, 7]))
                fe.append(rng.standard_normal(
                    (flen, self.frontend_dim), dtype=np.float32))
            out["frontend"] = np.stack(fe)
        return out


def batch_specs(cfg: Any, seq_len: int, global_batch: int
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input on the ``meta`` device (shape and
    dtype, nothing allocated)."""
    meta = lambda shape, dtype: torch.empty(  # noqa: E731
        shape, dtype=dtype, device="meta")
    specs = {"tokens": meta((global_batch, seq_len), torch.int32),
             "labels": meta((global_batch, seq_len), torch.int32)}
    if cfg.family == "audio":
        specs["frontend"] = meta((global_batch, seq_len, cfg.d_model),
                                 cfg.dtype)
    elif cfg.frontend_len:
        specs["frontend"] = meta((global_batch, cfg.frontend_len,
                                  cfg.d_model), cfg.dtype)
    return specs


def make_batch(cfg: Any, seq_len: int, global_batch: int, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    ds = SyntheticLMDataset(
        cfg.vocab, seq_len, global_batch, seed=seed,
        frontend_len=cfg.frontend_len, frontend_dim=cfg.d_model,
        family=cfg.family)
    return ds.batch(step)


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class DataLoader:
    """Prefetching loader: a background thread keeps ``prefetch`` batches
    ready on ``device`` (default ``"cuda"``; raises where CUDA is absent).
    Yields ``(step, batch)`` from ``start_step`` on; :meth:`close` stops
    the thread.

    ``shardings`` is the reference's map of input name to
    :class:`~repro_torch.parallel.NamedSharding` (the trainer's batch
    specs), in the reference's place.  Every rank lives on the one card,
    so each batch goes there whole; the map is kept as
    ``self.shardings``."""

    def __init__(self, dataset: SyntheticLMDataset,
                 shardings: Optional[Dict[str, Any]] = None,
                 start_step: int = 0, prefetch: int = 2, *,
                 device: DeviceLike = None) -> None:
        if shardings is not None and not isinstance(shardings, dict):
            raise TypeError(f"shardings must map input names to "
                            f"NamedSharding, got {shardings!r}; pass a "
                            f"device as device=")
        self.dataset = dataset
        self.shardings = shardings
        self.device = resolve_device(device)
        self.step = start_step
        self.prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            try:
                batch = to_device(self.dataset.batch(step), self.device)
            except Exception as e:  # surface in the consumer
                self._q.put(e)
                return
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        """Stop the thread: drain the queue so that a blocked ``put``
        returns, then join."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
