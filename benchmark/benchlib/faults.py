"""Faults planted in the program underneath the timed path, for the
checks that the comparison deciding ``correct`` catches them
(``tools/control.py`` on the card, ``tests/test_bench_faults.py`` on the
CPU).  A training cell can have two of them: a step that returns its
state unchanged, and half of the batch (a view's pixels) left out with
the mean taken over the rest."""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch")


@contextlib.contextmanager
def planted(name: str):
    """Plant the fault ``name`` in ``svgir_tpu_torch`` while the context
    is open (build the program's step inside it)."""
    from svgir_tpu_torch.train import optim
    from svgir_tpu_torch.utils import losses

    if name == "unchanged":
        mod, attr = optim, "adam_step"

        def broken(params, grads, state, lrs):
            return params, state
    elif name == "half_batch":
        mod, attr = losses, "l1_loss"

        def broken(a, b):
            h = a.shape[-2] // 2
            return (a[..., :h, :] - b[..., :h, :]).abs().mean()
    else:
        raise ValueError(f"unknown fault {name!r} (known: {FAULTS})")
    saved = getattr(mod, attr)
    setattr(mod, attr, broken)
    try:
        yield
    finally:
        setattr(mod, attr, saved)
