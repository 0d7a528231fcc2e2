"""``optimizer.name: adafactor``: the JAX package's optax chain as a torch
optimizer (``titok_tpu/training/train_step.py:make_optimizers``).

The chain after the global-norm clip (:func:`train_step.optimizer_step`
does that part for every optimizer):

1. ``optax.scale_by_factored_rms()`` with its defaults: the second-moment
   decay ``1 - (t + 1)^-0.8`` at the update count ``t``, ``g² + 1e-30``,
   and a factored estimate (a row and a column mean) for a tensor whose two
   largest dims are both at least 128; a full ``v`` for every other;
2. ``optax.clip_by_block_rms(1.0)``, per tensor;
3. ``optax.ema(momentum, debias=False, accumulator_dtype=bfloat16)``, left
   out when ``momentum`` is 0;
4. ``optax.add_decayed_weights(weight_decay)``, left out when it is 0;
5. ``optax.scale_by_learning_rate``: the update times ``-lr``, added to the
   param.

Not ``torch.optim.Adafactor``, whose algorithm is another: it has no block
RMS clip and no bf16 momentum, and treats epsilon and the decay otherwise.

Two things carry over from JAX as the jitted train step computes them:

- **the momentum's decay is rounded to bf16** (0.9 becomes 0.8984375):
  optax multiplies the bf16 accumulator by the Python float, which JAX
  casts to the accumulator's dtype. XLA then keeps that product in f32
  (excess precision) and adds ``(1 - momentum) * u`` in f32; the f32 sum is
  the update and its bf16 rounding the new accumulator;
- **layout**: the port keeps a Dense kernel transposed (``weights.py``:
  torch ``[out, in]`` is flax ``[in, out]``), so a 2-D tensor's dims are
  ranked as optax ranks the flax kernel's: by size, a tie going to the
  flax kernel's first dim as the smaller. ``v_row`` and ``v_col`` are then
  JAX's own vectors. (The update does not depend on which is which in
  exact arithmetic; the order of the sums does.)

The non-finite guard zeroes the grads and the optimizer still steps, as
JAX's chain does on zero grads: the moments decay, the count advances and
weight decay applies.

State per param: ``step`` (the count, an int), ``v_row`` and ``v_col`` (f32)
or ``v`` (f32, the param's shape), and ``m`` (bf16, the param's shape) when
``momentum`` is not 0.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_EXPONENT = 0.8
EPSILON = 1e-30
CLIP_THRESHOLD = 1.0


def factored_dims(shape: tuple, min_dim_size_to_factor: int = MIN_DIM_SIZE_TO_FACTOR):
    """``(d1, d0)``, the second-largest and the largest dim of a tensor of
    ``shape`` as optax's ``_factored_dims`` picks them (on the flax shape:
    a 2-D tensor's is its reverse), or None when the tensor keeps a full
    ``v``."""
    if len(shape) < 2:
        return None
    flax_shape = shape[::-1] if len(shape) == 2 else shape
    order = np.argsort(flax_shape, kind="stable")
    if flax_shape[order[-2]] < min_dim_size_to_factor:
        return None
    d1, d0 = int(order[-2]), int(order[-1])
    if len(shape) == 2:
        d1, d0 = 1 - d1, 1 - d0
    return d1, d0


def _f32(x: float) -> float:
    return float(np.float32(x))


class Adafactor(torch.optim.Optimizer):
    """The JAX package's adafactor chain (see the module's docstring).
    ``lr`` is set before each step, as for the port's AdamW
    (:func:`train_step.optimizer_step`)."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=float(momentum),
                                      weight_decay=float(weight_decay)))

    def _init_state(self, p: torch.Tensor, momentum: float) -> dict:
        state = {"step": 0}
        dims = factored_dims(p.shape)
        if dims is None:
            state["v"] = torch.zeros_like(p, dtype=torch.float32)
        else:
            d1, d0 = dims
            shape = list(p.shape)
            state["v_row"] = p.new_zeros([s for i, s in enumerate(shape) if i != d0],
                                         dtype=torch.float32)
            state["v_col"] = p.new_zeros([s for i, s in enumerate(shape) if i != d1],
                                         dtype=torch.float32)
        if momentum:
            state["m"] = torch.zeros_like(p, dtype=torch.bfloat16)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            mom, wd = group["momentum"], group["weight_decay"]
            # JAX: (1 - momentum) in f32 on the update, momentum as bf16 on
            # the accumulator; -lr in f32
            mom_new = _f32(1.0 - mom)
            mom_old = float(torch.tensor(mom, dtype=torch.bfloat16))
            neg_lr = _f32(-group["lr"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p, mom))
                g = p.grad.to(torch.float32)
                t = np.float32(state["step"] + 1)
                decay = np.float32(1.0) - t ** np.float32(-DECAY_EXPONENT)
                keep, add = float(decay), float(np.float32(1.0) - decay)
                g2 = g * g + EPSILON
                dims = factored_dims(p.shape)
                if dims is None:
                    v = state["v"]
                    v.mul_(keep).add_(g2 * add)
                    u = g * torch.rsqrt(v)
                else:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.mul_(keep).add_(g2.mean(dim=d0) * add)
                    v_col.mul_(keep).add_(g2.mean(dim=d1) * add)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = torch.rsqrt(v_row / v_row.mean(dim=reduced_d1, keepdim=True))
                    u = g * row_factor.unsqueeze(d0) * torch.rsqrt(v_col).unsqueeze(d1)
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / CLIP_THRESHOLD, min=1.0)
                if mom:
                    m = state["m"]
                    u = u * mom_new + m.to(torch.float32) * mom_old
                    m.copy_(u)
                if wd:
                    u = u + p.to(torch.float32) * wd
                p.add_((u * neg_lr).to(p.dtype))
                state["step"] += 1
        return loss

    def load_state_dict(self, state_dict):
        """Torch's load, which casts every floating state to its param's
        dtype, then the momentum back to bf16 (exact: it was bf16)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "m" in state:
                state["m"] = state["m"].to(torch.bfloat16)
