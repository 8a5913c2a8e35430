"""FP16_Optimizer (cut-down, for FusedAdam) — a flat fp32 master.

Twin of ``apex_tpu/optimizers/fp16_optimizer.py`` (reference
``apex/optimizers/fp16_optimizer.py``): a wrapper for FusedAdam only,
which keeps the half params' fp32 master as one flat buffer (:61-67),
takes the grad norm with -1 flagging an overflow (:103-128), skips the
step and adjusts its own dynamic scale on overflow (2^16 initial, window
1000, factor 2, :73-86), and otherwise runs FusedAdam's step on the
master with the norm and the scale (:130-152).

The master is the flat buffer of the inner FusedAdam's state (its one
leaf is the whole master), so the update is one launch of B1 over it in
place; the overflow skip runs inside that launch and the scaler is
device-resident, so a step reads nothing back to the host.  The half
params returned are casts of the master (new tensors).  This is not
``fp16_utils.FP16_Optimizer``, the general legacy wrapper.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.ops.flatten import FlatSpec, flatten, flatten_like, \
    unflatten
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState

Tree = Any


class FP16OptimizerState(NamedTuple):
    master: torch.Tensor         # fp32 flat master weights (= inner.p)
    inner: FusedAdamState        # FusedAdam over the one-leaf master
    scaler: LossScalerState
    spec: FlatSpec               # layout of the half-param tree


class FP16_Optimizer:
    def __init__(self, init_optimizer: FusedAdam,
                 static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        if not isinstance(init_optimizer, FusedAdam):
            raise TypeError(
                "apex_tpu_torch.optimizers.FP16_Optimizer wraps FusedAdam "
                "only (matching the reference's design); for general "
                "optimizers use apex_tpu_torch.fp16_utils.FP16_Optimizer "
                "or amp.initialize.")
        if init_optimizer.layout != "flat" or init_optimizer.param_groups:
            raise ValueError("FP16_Optimizer takes a FusedAdam with the "
                             "flat layout and no param_groups: its one "
                             "leaf is the whole master")
        self.optimizer = init_optimizer
        args = dynamic_loss_args or {}
        if dynamic_loss_scale:
            # reference optimizers/fp16_optimizer.py:73-86
            self.loss_scaler = LossScaler(
                "dynamic", init_scale=args.get("init_scale", 2.0 ** 16),
                scale_factor=args.get("scale_factor", 2.0),
                scale_window=args.get("scale_window", 1000))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.verbose = verbose

    def init(self, params_half: Tree) -> FP16OptimizerState:
        master, spec = flatten(params_half, dtype=torch.float32,
                               pad_to=self.optimizer.pad_to)
        inner = self.optimizer.init((master,))
        return FP16OptimizerState(master=inner.p, inner=inner,
                                  scaler=self.loss_scaler.init(inner.p.device),
                                  spec=spec)

    # -- reference API ------------------------------------------------------
    def scale_loss(self, loss, state: FP16OptimizerState):
        """Replaces ``optimizer.backward(loss)``: the loss times the
        scale, to differentiate (reference ``backward`` :161-178)."""
        return self.loss_scaler.scale_loss(loss, state.scaler)

    def _flat_grads(self, grads: Tree, state: FP16OptimizerState):
        g = flatten_like(grads, state.spec, dtype=torch.float32)
        return torch.cat([g, g.new_zeros(state.master.shape[0] - g.shape[0])])

    def compute_grad_norm(self, grads: Tree, state: FP16OptimizerState):
        """fp32 grad norm; -1 flags an overflow (reference :103-128)."""
        norm = torch.linalg.vector_norm(self._flat_grads(grads, state))
        return torch.where(torch.isfinite(norm), norm, -1.0)

    def step(self, params_half: Tree, grads: Tree,
             state: FP16OptimizerState):
        """Scaled half grads in, new half params out (reference
        :130-152).  The overflow skip runs inside the kernel: a skipped
        step keeps the master's bits, so the half params cast from it
        are the old ones.  The state is consumed."""
        del params_half  # derived from the master, see the docstring
        g = self._flat_grads(grads, state)
        norm = torch.linalg.vector_norm(g)
        overflow = ~torch.isfinite(norm)
        new_scaler = self.loss_scaler.update(state.scaler, overflow)
        opt = self.optimizer
        _, inner = opt.step((state.inner.p,), (g,), state.inner,
                            scale=state.scaler.loss_scale, grad_norm=norm,
                            skip=overflow)
        with torch.no_grad():
            params_out = unflatten(inner.p, state.spec)  # cast back to half
        return params_out, FP16OptimizerState(
            master=inner.p, inner=inner, scaler=new_scaler, spec=state.spec)

    def loss_scale(self, state: FP16OptimizerState):
        return state.scaler.loss_scale
