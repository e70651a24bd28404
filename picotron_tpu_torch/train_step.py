"""The single-device training step of the PyTorch port.

Port of ``picotron_tpu/train_step.py`` at dp = tp = pp = cp = 1:

- ``lr_schedule`` (:51): optax's constant / warmup / cosine / linear
  schedules, evaluated in float32 as optax evaluates them;
- ``adamw_update``: ``build_optimizer``'s (:77) ``optax.adamw`` written
  out in optax's arithmetic and order, with the moments in the parameter
  dtype and every scalar rounded to the leaf's dtype before it is applied
  (as JAX applies a weak-typed Python scalar). ``torch.optim.AdamW``
  decays first and folds the bias corrections differently, which agrees
  in fp32 but drifts in bf16. Weight decay applies to every leaf;
- ``build_train_step`` (:282) over ``no_pipeline`` (``parallel/pp.py:78``):
  gradients of ``stage_apply`` accumulate over the M micro-batches in
  ``training.grad_accum_dtype`` and are divided by M; the global norm of
  the accumulated gradients feeds the clip (fp32 gradients are clipped,
  then cast to the parameter dtype, :436-443) and the non-finite gate
  (:447-462): a step whose loss or gradient norm is not finite changes
  neither the parameters nor the optimizer state;
- ``init_state`` (:249).

The JAX step is one jitted program returning new arrays. Here the
parameters and the optimizer state are updated in place (no second copy
of either on the card) and the same objects are returned. The gate reads
its verdict on the host, one synchronisation per step, before any update.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.utils import torch_dtype

_F32 = np.float32


def _linear(init: float, end: float, steps: int, begin: int = 0):
    """optax.linear_schedule (a polynomial schedule of power 1)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        c = min(max(count - begin, 0), steps)
        frac = _F32(1) - _F32(c) / _F32(steps)
        return _F32(init - end) * frac + _F32(end)

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule with exponent 1."""
    def schedule(count):
        c = min(_F32(count), _F32(decay_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c
                                              / _F32(decay_steps)))
        return _F32(init) * (_F32(1 - alpha) * cosine + _F32(alpha))

    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def lr_schedule(t):
    """The learning rate as a function of the optimizer's step count (0
    for the first update): optional linear warmup from 0 over
    ``lr_warmup_steps``, then constant / cosine / linear decay to
    ``learning_rate * lr_min_ratio`` over ``lr_decay_steps`` (default
    ``total_train_steps``). A plain float for the default (constant, no
    warmup), as in the JAX package."""
    peak = t.learning_rate
    w = t.lr_warmup_steps
    if t.lr_schedule == "constant" and w == 0:
        return peak
    total = (t.lr_decay_steps if t.lr_decay_steps is not None
             else t.total_train_steps)
    end = peak * t.lr_min_ratio
    if t.lr_schedule == "constant":
        return _join([_linear(0.0, peak, w), lambda count: peak], [w])
    if t.lr_schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, peak, w, max(total, w + 1),
        # end)
        decay = max(total, w + 1)
        alpha = 0.0 if peak == 0.0 else end / peak
        return _join([_linear(0.0, peak, w), _cosine(peak, decay - w, alpha)],
                     [w])
    return _join([_linear(0.0, peak, w),
                  _linear(peak, end, max(total - w, 1))], [w])


def param_leaves(params: dict) -> list:
    """The parameter tensors in the JAX tree's leaf order (keys sorted at
    every level), so sums over leaves run in the same order."""
    out = []
    for key in sorted(params):
        v = params[key]
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


def _round(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as the leaf dtype holds it (JAX casts a weak-typed
    scalar to the array's dtype before the operation)."""
    return torch.tensor(x, dtype=torch.float64).to(dtype).item()


@torch.no_grad()
def adamw_update(params: list, grads: list, opt_state: dict, t,
                 lr: float) -> None:
    """One ``optax.adamw`` update, in place, for leaves of one or more
    dtypes: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``,
    ``u = (mu/bc1) / (sqrt(nu/bc2) + eps) + wd·p``, ``p = p + (-lr)·u``,
    with ``bc = 1 - b**count`` in float32 and every scalar in the leaf's
    dtype; ``opt_state["count"]`` advances by one."""
    count = opt_state["count"] + 1
    b1, b2 = t.adam_beta1, t.adam_beta2
    bc1 = _F32(1) - np.power(_F32(b1), _F32(count), dtype=_F32)
    bc2 = _F32(1) - np.power(_F32(b2), _F32(count), dtype=_F32)
    groups: dict = {}
    for i, p in enumerate(params):
        groups.setdefault(p.dtype, []).append(i)
    for dt, idx in groups.items():
        p = [params[i] for i in idx]
        g = [grads[i] for i in idx]
        mu = [opt_state["mu"][i] for i in idx]
        nu = [opt_state["nu"][i] for i in idx]
        torch._foreach_mul_(mu, _round(b1, dt))
        torch._foreach_add_(mu, torch._foreach_mul(g, _round(1 - b1, dt)))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, _round(1 - b2, dt))
        torch._foreach_mul_(nu, _round(b2, dt))
        torch._foreach_add_(nu, g2)
        del g2
        denom = torch._foreach_div(nu, _round(bc2, dt))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _round(t.adam_eps, dt))
        u = torch._foreach_div(mu, _round(bc1, dt))
        torch._foreach_div_(u, denom)
        del denom
        torch._foreach_add_(u, torch._foreach_mul(p, _round(t.weight_decay,
                                                            dt)))
        torch._foreach_mul_(u, _round(-lr, dt))
        torch._foreach_add_(p, u)
    opt_state["count"] = count


def init_opt_state(params: dict) -> dict:
    """AdamW state: zero moments in the parameter dtype (optax's default),
    in ``param_leaves`` order, and the step count."""
    leaves = param_leaves(params)
    return {"count": 0,
            "mu": [torch.zeros_like(p) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves]}


def init_state(cfg: Config, device=None, seed: int | None = None) -> tuple:
    """(params, opt_state): the model's random init from ``seed`` (default
    ``training.seed``) on ``device``, the leaves marked for gradients."""
    seed = cfg.training.seed if seed is None else seed
    params = llama.init_params(cfg.model, seed=seed, device=device)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params, init_opt_state(params)


def loss_and_grads(params: dict, tokens: torch.Tensor,
                   targets: torch.Tensor, cos, sin, cfg: Config) -> tuple:
    """One micro-batch: (loss, gradients in ``param_leaves`` order) of
    ``stage_apply`` on tokens/targets [mbs, seq]."""
    leaves = param_leaves(params)
    with torch.enable_grad():
        _, loss = llama.stage_apply(params, tokens, targets, cos, sin, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def build_train_step(cfg: Config, poison_nonfinite: bool = False):
    """Returns ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)``. tokens/targets are [M, mbs, seq] integer arrays
    (numpy or torch); params and opt_state are updated in place and
    returned; loss is the fp32 mean over the micro-batches, a 0-dim tensor
    on the parameters' device.

    ``poison_nonfinite=True`` adds NaN to the loss and every gradient
    after the backward (the JAX package's chaos build), to drive the
    non-finite gate."""
    cfg.check_trainable()
    t = cfg.training
    guard = cfg.resilience.nonfinite_guard
    acc_dt = (torch_dtype(cfg.model.dtype) if t.grad_accum_dtype == "param"
              else torch.float32)
    sched = lr_schedule(t)
    cos_cpu, sin_cpu = llama.rope_tables(cfg)
    tables = {}

    def step(params, opt_state, tokens, targets):
        leaves = param_leaves(params)
        device = leaves[0].device
        if device not in tables:
            tables[device] = (cos_cpu.to(device), sin_cpu.to(device))
        cos, sin = tables[device]
        tokens = torch.as_tensor(tokens, device=device)
        targets = torch.as_tensor(targets, device=device)
        M = tokens.shape[0]
        gacc = None
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(M):
            loss, grads = loss_and_grads(params, tokens[i], targets[i], cos,
                                         sin, cfg)
            grads = [g.to(acc_dt) for g in grads]
            if gacc is None:
                gacc = grads  # 0 + g: the JAX accumulator's first add
            else:
                torch._foreach_add_(gacc, grads)
            del grads
            loss_acc += loss.float()
        loss = loss_acc / M
        if M > 1:
            torch._foreach_div_(gacc, M)
        if poison_nonfinite:
            loss = loss + float("nan")
            torch._foreach_add_(gacc, float("nan"))
        sq = torch.zeros((), dtype=torch.float32, device=device)
        for g in gacc:
            sq += g.float().square().sum()
        if t.grad_clip > 0:
            scale = torch.clamp(t.grad_clip / torch.clamp(sq.sqrt(), min=1e-16),
                                max=1.0)
            torch._foreach_mul_(gacc, scale.to(acc_dt))
        ok = bool(torch.isfinite(loss) & torch.isfinite(sq)) if guard else True
        if ok:
            grads = [g.to(p.dtype) for g, p in zip(gacc, leaves)]
            del gacc
            count = opt_state["count"]
            lr = float(sched(count)) if callable(sched) else sched
            adamw_update(leaves, grads, opt_state, t, lr)
        return params, opt_state, loss

    return step
