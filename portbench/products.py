"""The appearance products of a tracker's step, read where they are made.

A replay cell's rows are decisions (matches, ids), which rounding in the
step's products changes only where two costs nearly tie; so the check also
holds the products themselves: every ``torch.bmm`` that the step makes in a
few steps drawn from the seed, copied as it is made, against the
reference's in the same steps."""

from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

BMM = (torch.bmm, torch.Tensor.bmm)


class Products(TorchFunctionMode):
    """Keeps a copy of every ``torch.bmm`` result made under it."""

    def __init__(self):
        super().__init__()
        self.out: list[torch.Tensor] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in BMM:
            self.out.append(out.detach().clone())
        return out


def sample_steps(seed: int, n_steps: int, k: int) -> list[int]:
    """``k`` distinct steps of ``n_steps`` drawn from ``seed``, in order."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 11])
    return sorted(int(i) for i in rng.choice(n_steps, size=min(k, n_steps), replace=False))


def recording(step, steps: list[int], kept: dict, first: int = 0):
    """``step`` with the products of its calls ``first + steps`` (counted
    from its first call through this wrapper) kept in ``kept[step index]``."""
    wanted = {first + s: s for s in steps}
    seen = {"i": 0}

    def recorded(*args, **kwargs):
        i = seen["i"]
        seen["i"] += 1
        if i not in wanted:
            return step(*args, **kwargs)
        with Products() as mode:
            out = step(*args, **kwargs)
        kept[wanted[i]] = mode.out
        return out

    return recorded


def gap(got: dict, want: dict) -> float | None:
    """The largest element gap between the program's products and the
    reference's, step by step and in the order made; None where a sampled
    step's products are missing or differ in number or shape."""
    worst = 0.0
    for s, ref in want.items():
        mine = got.get(s)
        if mine is None or len(mine) != len(ref) or not ref:
            return None
        for a, b in zip(mine, ref):
            if a.shape != b.shape:
                return None
            worst = max(worst, float((a.cpu() - b.cpu()).abs().max()))
    return worst
