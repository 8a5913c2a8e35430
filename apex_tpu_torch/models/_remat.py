"""Rematerialisation of one block: the twin of flax's ``nn.remat``.

``remat(module, scope, *args, **kwargs)`` runs ``module(*args,
dropout_key=..., **kwargs)`` under ``torch.utils.checkpoint``
(non-reentrant): the block's activations are not kept, and the backward
runs its forward again.  The recompute must run what the forward ran,
which three things around a block would otherwise change:

- the parameters: ``amp.AmpModel.apply`` hands the module its cast
  parameters through ``torch.func.functional_call`` only for the call,
  so the block runs on the parameters it held at the forward, passed as
  inputs of the checkpoint (their gradients flow back through them);
- the forward hooks on the block's modules (amp O1's norm-output
  recasts, also registered for the call only): the recompute puts back
  those the forward saw;
- the dropout keys: ``RngScope.make_rng`` advances shared counters, so
  each run draws from a fresh fork of one snapshot of the block's scope
  (``RngScope.fork``) and draws the same keys, as ``nn.remat`` replays
  the same rngs.  Attention seeds are drawn by the caller beforehand
  and passed in as ``attention_seed``.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def _hooks_back(hooks):
    """Register again the ``(module, hook)`` forward hooks that are not
    registered now; remove them on exit."""
    handles = [m.register_forward_hook(h) for m, h in hooks
               if not any(h is other for other in m._forward_hooks.values())]
    try:
        yield
    finally:
        for handle in handles:
            handle.remove()


def remat(module: nn.Module, scope, *args, **kwargs):
    """``module(*args, dropout_key=<a fork of scope>, **kwargs)``,
    rematerialised in the backward (see the module docstring)."""
    named = list(module.named_parameters())
    names = [name for name, _ in named]
    params = [p for _, p in named]
    hooks = [(m, h) for m in module.modules()
             for h in m._forward_hooks.values()]
    snap = None if scope is None else scope.fork()
    n = len(args)

    def run(*tensors):
        call_kwargs = dict(kwargs, dropout_key=None if snap is None
                           else snap.fork())
        with _hooks_back(hooks):
            return torch.func.functional_call(
                module, dict(zip(names, tensors[n:])), tensors[:n],
                call_kwargs)

    return checkpoint(run, *args, *params, use_reentrant=False)
