"""LCX quickstart on the PyTorch port: the paper's interface in 60 lines.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      [--ranks 4]

The port of ``examples/quickstart.py``.  It walks the core concepts on
an emulated axis of ranks: objectized flexible functions (Listing 1.1),
resources x operations orthogonality, the three completion object types,
matching engines, explicit progress, and a ring all-reduce built from
LCX puts.  The ranks are rank-stacked: every per-rank value is one row
of a tensor on the device (the card by default), and
``lcx.ranks.bind_axis`` plays the reference's ``vmap`` axis.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

import repro_torch.core as lcx  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def per_rank(x):
    # Default resources are allocated by the runtime (opt-out available).
    lcx.init()
    dev = lcx.Device(axis="x")                  # the "NIC" onto the mesh

    # --- Listing 1.1: objectized flexible functions -------------------
    # D d = foo_x(a1).c(c1)();  ->  chainable setters, any order, reusable
    sync = lcx.Synchronizer(threshold=1)
    op = lcx.put_x(x).perm(lcx.Perm.shift(1)).remote_comp(sync).device(dev)
    op()                                        # post (asynchronous!)
    lcx.progress()                              # explicit progress
    (ev,) = sync.wait()
    neighbour = ev.payload                      # RDMA-write-with-signal

    # --- any op x any completion object --------------------------------
    cq = lcx.CompletionQueue()
    fh = lcx.FunctionHandler(lambda e: e.payload * 2)
    lcx.am_x(x).perm(lcx.Perm.shift(2)).remote_comp(cq).device(dev)()
    lcx.am_x(x).perm(lcx.Perm.shift(1)).remote_comp(fh).device(dev)()
    lcx.progress()
    from_two_away = cq.pop().payload
    doubled = fh.results[0]

    # --- matched send/recv through a matching engine -------------------
    eng = lcx.MatchingEngine(kind="map", policy="rank_tag")
    s2 = lcx.Synchronizer(threshold=2)
    lcx.send_x(x * 10).perm(lcx.Perm.shift(1)).tag(7).comp(s2) \
        .matching_engine(eng).device(dev)()
    lcx.recv_x(x).perm(lcx.Perm.shift(1)).tag(7).comp(s2) \
        .matching_engine(eng).device(dev)()
    lcx.progress()
    matched = [e.payload for e in s2.wait() if e.payload is not None][0]

    # --- a collective built from LCX p2p -------------------------------
    total = lcx.all_reduce(x, device=dev, backend="ring")

    return neighbour, from_two_away, doubled, matched, total


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=4)
    args = p.parse_args()
    dev = resolve_device(args.device)
    xs = torch.arange(float(args.ranks), device=dev)
    with lcx.ranks.bind_axis("x", args.ranks):
        nb, two, dbl, matched, total = per_rank(xs)
    print("rank values:        ", xs.tolist())
    print("left neighbour:     ", nb.tolist())
    print("two ranks away:     ", two.tolist())
    print("am handler (2x):    ", dbl.tolist())
    print("matched send (10x): ", matched.tolist())
    print("ring all-reduce:    ", total.tolist())
    assert (total == xs.sum()).all()
    print("quickstart OK")


if __name__ == "__main__":
    main()
