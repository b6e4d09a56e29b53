"""Data-parallel training over a mesh of devices (the port's side of the JAX
ReID trainer's ``n_devices > 1`` mesh, ``boxmot_tpu/reid/training/
trainer.py:272-299``).

JAX runs one SPMD program: parameters, batch statistics, optimizer state and
EMA replicated, the P x K batch split over the mesh's ``batch`` axis, the
gradient all-reduce that XLA adds, and batch norms reduced over the whole
batch.  The port runs one process too.  ``DataParallel`` wraps a module that
lives on ``mesh[0]`` (the master, entry 0's replica) and keeps, for every
other entry, a copy on that entry whose buffers are set from the master's at
each call.  A call splits the batch into equal contiguous slices, one host
thread a slice (as ``torch.nn.parallel.parallel_apply``); each runs the
module with differentiable copies of the master parameters on its entry
(``torch.func.functional_call``).  At each batch norm the shards meet
(``ShardReduction``, through ``models/layers.py::shard_reduction``): every
shard forms the same totals, in entry order, of the shards' per-channel
sums, so the batch norms normalize with the whole batch's statistics and
move every replica's running statistics alike.  The outputs are gathered on
``mesh[0]``, where the caller's loss sees the whole batch; one
``torch.autograd.grad`` of that loss with respect to the master parameters
sums every replica's gradient through the copies, which is the all-reduce.
A shard that raises aborts the others' barrier, and its error reaches the
caller.

On one card, a mesh of the same card twice runs exactly this code; only the
copies between entries become copies within the card.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from functools import partial

import torch
from torch.func import functional_call

from boxmot_tpu_torch.models.layers import shard_reduction


class ShardReduction:
    """Sums of ``n`` shards that run in ``n`` threads, met at a barrier."""

    def __init__(self, n: int):
        self._barrier = threading.Barrier(n)
        self._slots = [None] * n

    def abort(self) -> None:
        """Release every shard waiting here with ``BrokenBarrierError``."""
        self._barrier.abort()

    def reduce(self, index: int, sums: tuple, count: int):
        """Shard ``index``'s tensors ``sums`` and element count -> the totals
        over every shard, on this shard's device, summed in entry order (the
        same values on every shard), and the total count."""
        self._slots[index] = (sums, count)
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()  # every shard holds the parts before the next call
        device = sums[0].device
        totals = []
        for k in range(len(sums)):
            t = parts[0][0][k].to(device)
            for other, _ in parts[1:]:
                t = t + other[k].to(device)
            totals.append(t)
        return tuple(totals), sum(c for _, c in parts)


def _run_shards(fn, n: int, abort) -> list:
    """``[fn(0), ..., fn(n - 1)]``, ``fn(0)`` on the calling thread and the
    others in threads of their own; when one raises, ``abort()`` frees the
    rest and the first error (not a broken barrier) is raised."""
    results, errors = [None] * n, [None] * n

    def work(i):
        try:
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            abort()

    threads = [threading.Thread(target=work, args=(i,), daemon=True) for i in range(1, n)]
    for t in threads:
        t.start()
    work(0)
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        raise next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)),
                   raised[0])
    return results


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class DataParallel:
    """``module`` (on ``mesh[0]``) run data-parallel over ``mesh``: a call
    on a batch whose leading axis divides ``len(mesh)`` returns the module's
    output over the whole batch on ``mesh[0]``, differentiable with respect
    to the module's own parameters."""

    def __init__(self, module: torch.nn.Module, mesh):
        self.module, self.mesh = module, tuple(mesh)
        self.replicas = [module] + [copy.deepcopy(module).to(d) for d in self.mesh[1:]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.mesh)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} must divide the mesh's {n} devices")
        size = x.shape[0] // n
        params = dict(self.module.named_parameters())
        with torch.no_grad():
            for replica in self.replicas[1:]:
                replica.train(self.module.training)
                for mine, master in zip(replica.buffers(), self.module.buffers()):
                    mine.copy_(master)
        group = ShardReduction(n)
        grad = torch.is_grad_enabled()  # grad mode is per thread

        def shard(i):
            dev = self.mesh[i]
            xi = x[i * size:(i + 1) * size].to(dev)
            with torch.set_grad_enabled(grad), _on(dev), shard_reduction(partial(group.reduce, i)):
                if i == 0:
                    return self.module(xi)
                return functional_call(self.replicas[i],
                                       {k: p.to(dev) for k, p in params.items()}, (xi,))

        outs = _run_shards(shard, n, group.abort)
        return torch.cat([o.to(self.mesh[0]) for o in outs])
