"""LARC: layer-wise adaptive rate control.

Twin of ``apex_tpu/parallel/LARC.py`` (reference
``apex/parallel/LARC.py:133-224``).  Before the wrapped optimizer's
step, each parameter tensor's gradient is rescaled by a local rate

    local_lr = trust_coefficient * ||p|| / (||g|| + weight_decay*||p|| + eps)

``clip`` mode scales by ``min(local_lr / base_lr, 1)`` (the wrapped
optimizer applies ``base_lr``), scale mode by ``local_lr``; weight
decay is folded into the gradient first, so the wrapped optimizer must
not apply its own.  Where either norm is 0 the gradient passes as it
is.  ``param_groups`` (``optimizers.param_groups``) override
``trust_coefficient``, ``weight_decay`` and ``eps`` by parameter name.

It wraps an optimizer in optax's protocol (``init``/``update``, e.g.
``optimizers.transforms.sgd``) or a fused one (``init``/``step``, e.g.
``FusedAdam``), and forwards the fused overflow skip to the latter.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.optimizers.param_groups import hparam_for_path, \
    leaf_names, validate_specs
from apex_tpu_torch.optimizers.transforms import apply_updates

Tree = Any


class LARC:
    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 weight_decay: float = 0.0, base_lr: Optional[float] = None,
                 param_groups=None):
        """``base_lr`` (clip mode) defaults to the wrapped optimizer's
        ``lr`` or ``learning_rate`` where it has one."""
        self.optimizer = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay
        self.param_groups = list(param_groups) if param_groups else []
        if self.param_groups:
            validate_specs(self.param_groups,
                           ("trust_coefficient", "weight_decay", "eps"),
                           "LARC")
        if base_lr is None:
            base_lr = getattr(optimizer, "lr",
                              getattr(optimizer, "learning_rate", None))
        if self.clip and base_lr is None:
            raise ValueError("LARC clip mode needs base_lr (could not infer "
                             "from the wrapped optimizer)")
        self.base_lr = base_lr

    def _adapt(self, grads: Tree, params: Tree) -> Tree:
        defaults = {"trust_coefficient": self.trust_coefficient,
                    "weight_decay": self.weight_decay, "eps": self.eps}
        g_leaves, spec = pytree.tree_flatten(grads)
        p_leaves = pytree.tree_leaves(params)
        out = []
        with torch.no_grad():
            for name, g, p in zip(leaf_names(grads), g_leaves, p_leaves):
                hp = hparam_for_path(name, defaults, self.param_groups)
                g32, p32 = g.float(), p.float()
                pn = torch.linalg.vector_norm(p32)
                gn = torch.linalg.vector_norm(g32)
                safe = (pn > 0) & (gn > 0)
                local_lr = hp["trust_coefficient"] * pn / (
                    gn + hp["weight_decay"] * pn + hp["eps"])
                if self.clip:
                    scale = torch.clamp_max(local_lr / self.base_lr, 1.0)
                else:
                    scale = local_lr
                adjusted = (g32 + hp["weight_decay"] * p32) * scale
                out.append(torch.where(safe, adjusted, g32).to(g.dtype))
        return pytree.tree_unflatten(out, spec)

    # -- optax protocol ----------------------------------------------------
    def init(self, params: Tree):
        return self.optimizer.init(params)

    def update(self, grads: Tree, state, params: Optional[Tree] = None):
        if params is None:
            raise ValueError("LARC.update requires params")
        return self.optimizer.update(self._adapt(grads, params), state,
                                     params)

    # -- apex-style --------------------------------------------------------
    @property
    def supports_fused_skip(self) -> bool:
        """amp's overflow skip goes into the wrapped optimizer's update
        when it takes one (FusedAdam, FusedLAMB)."""
        return getattr(self.optimizer, "supports_fused_skip", False)

    def step(self, params: Tree, grads: Tree, state, skip=None):
        if hasattr(self.optimizer, "step"):
            if skip is not None and not self.supports_fused_skip:
                raise TypeError(
                    "LARC: skip= given but the wrapped optimizer has no "
                    "fused skip support")
            kw = {"skip": skip} if self.supports_fused_skip else {}
            return self.optimizer.step(params, self._adapt(grads, params),
                                       state, **kw)
        if skip is not None:
            raise TypeError("LARC: skip= requires a wrapped optimizer "
                            "with fused skip support")
        updates, state = self.update(grads, state, params)
        with torch.no_grad():
            return apply_updates(params, updates), state
