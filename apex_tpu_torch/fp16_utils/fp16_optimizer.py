"""General FP16_Optimizer: fp32 master weights around any optimizer.

Twin of ``apex_tpu/fp16_utils/fp16_optimizer.py`` (reference
``apex/fp16_utils/fp16_optimizer.py``), the manual counterpart of amp
O2.  The model's parameters stay one tree (half, fp32 or mixed) and the
master copy is its fp32 cast: an fp32 leaf gets a same-valued master,
the reference's "fp32_from_fp32" group with no bookkeeping.  The wrapped
optimizer is one in optax's protocol (``optimizers.transforms``:
``init(params)``, ``update(grads, state, params)``).

API mapping (reference -> here):

- ``optimizer.backward(loss)`` (:462) -> differentiate
  ``scale_loss(loss, state)``;
- ``update_master_grads()`` (:525) -> ``update_master_grads(grads,
  state)``: fp32 master gradients, the overflow flag and the new state;
- ``clip_master_grads(max_norm)`` (:274) -> ``clip_master_grads``;
- ``step()`` (:361) -> ``step(params, grads, state)``: the whole
  protocol; an overflowed step keeps every bit of the params, the
  masters and the inner state (a select on the device, no host sync);
- ``state_dict``/``load_state_dict`` (:298-359, masters saved beside the
  wrapped optimizer's state).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.amp.optimizer import _tree_select
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.fp16_utils.fp16util import clip_grad_norm
from apex_tpu_torch.ops.multi_tensor import multi_tensor_unscale
from apex_tpu_torch.optimizers.transforms import apply_updates

Tree = Any


class FP16OptimizerState(NamedTuple):
    master: Tree               # fp32 master params (the model's tree)
    inner: Any                 # the wrapped optimizer's state (on masters)
    scaler: LossScalerState


class FP16_Optimizer:
    """Master-weight wrapper for an optimizer in optax's protocol.

    ``static_loss_scale`` is a float or ``"dynamic"`` (the reference takes
    both spellings, :83-124), or pass ``dynamic_loss_scale=True``.  The
    dynamic scale takes the legacy defaults of the reference's
    ``FP16_Optimizer`` (2**32 init, window 1000), overridable through
    ``dynamic_loss_args``."""

    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        self.optimizer = init_optimizer
        if static_loss_scale == "dynamic":
            dynamic_loss_scale = True
        args = dynamic_loss_args or {}
        if dynamic_loss_scale:
            # the legacy DynamicLossScaler defaults (reference
            # loss_scaler.py:47), not amp's 2**16 / 2000
            self.loss_scaler = LossScaler(
                "dynamic",
                init_scale=args.get("init_scale", 2.0 ** 32),
                scale_factor=args.get("scale_factor", 2.0),
                scale_window=args.get("scale_window", 1000),
                max_loss_scale=args.get("max_loss_scale", 2.0 ** 32))
        else:
            self.loss_scaler = LossScaler(float(static_loss_scale))
        self.verbose = verbose

    def init(self, params: Tree) -> FP16OptimizerState:
        """The fp32 masters (copies), the inner state and the scaler
        state, on the parameters' device."""
        master = pytree.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
        device = pytree.tree_leaves(params)[0].device
        return FP16OptimizerState(master=master,
                                  inner=self.optimizer.init(master),
                                  scaler=self.loss_scaler.init(device))

    def scale_loss(self, loss: torch.Tensor, state: FP16OptimizerState):
        """The scaled loss to differentiate (``backward(loss)``)."""
        return self.loss_scaler.scale_loss(loss, state.scaler)

    def update_master_grads(self, grads: Tree, state: FP16OptimizerState):
        """Model gradients unscaled into fp32 master gradients, with the
        overflow flag (reference :525-580).  Returns ``(master_grads,
        overflow, state)``, the state's scaler updated."""
        g, overflow = multi_tensor_unscale(grads, state.scaler.loss_scale,
                                           out_dtype=torch.float32)
        scaler = self.loss_scaler.update(state.scaler, overflow)
        return g, overflow, state._replace(scaler=scaler)

    def clip_master_grads(self, master_grads: Tree, max_norm: float,
                          norm_type: float = 2.0):
        """The fp32 master gradients clipped by their global norm
        (reference :274-296): ``(clipped_grads, total_norm)``."""
        return clip_grad_norm(master_grads, max_norm, norm_type)

    def step(self, params: Tree, grads: Tree, state: FP16OptimizerState, *,
             max_grad_norm: Optional[float] = None
             ) -> Tuple[Tree, FP16OptimizerState]:
        """unscale -> (clip) -> the inner step on the masters -> the skip
        select -> the masters cast back to the model's dtypes (reference
        :361-460).  Returns ``(params, state)``."""
        g, overflow, state = self.update_master_grads(grads, state)
        if max_grad_norm is not None:
            g, _ = self.clip_master_grads(g, max_grad_norm)
        keep = ~overflow
        with torch.no_grad():
            updates, new_inner = self.optimizer.update(g, state.inner,
                                                       state.master)
            new_master = apply_updates(state.master, updates)
            master = _tree_select(keep, new_master, state.master)
            inner = _tree_select(keep, new_inner, state.inner)
            new_params = pytree.tree_map(lambda p, m: m.to(p.dtype),
                                         params, master)
            params_out = _tree_select(keep, new_params, params)
        params_out = pytree.tree_map(
            lambda new, old: new.requires_grad_(old.requires_grad),
            params_out, params)
        return params_out, FP16OptimizerState(master=master, inner=inner,
                                              scaler=state.scaler)

    def state_dict(self, state: FP16OptimizerState) -> dict:
        """The masters and the scaler saved beside the inner state (the
        reference's layout, :298-317)."""
        return {"master_params": state.master,
                "optimizer_state": state.inner,
                "loss_scaler": state.scaler._asdict()}

    def load_state_dict(self, d: dict) -> FP16OptimizerState:
        """The inverse of :meth:`state_dict` (reference :319-359)."""
        return FP16OptimizerState(master=d["master_params"],
                                  inner=d["optimizer_state"],
                                  scaler=LossScalerState(**d["loss_scaler"]))

    def loss_scale(self, state: FP16OptimizerState):
        return state.scaler.loss_scale

    def inspect_master_grad_data(self, master_grads: Tree):
        """The master gradients as a flat list (reference :582-615's
        debugging aid)."""
        return pytree.tree_leaves(master_grads)
