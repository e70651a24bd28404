"""Carry parameters and AdamW state between the JAX package and the port.

Both packages keep the same tree: ``{"embed", "layers": {leaf: [L, ...]},
"final_norm", "lm_head"}`` with linear weights ``(in, out)``. So a JAX
parameter tree, once fetched to numpy (``jax.tree.map(np.asarray, p)``),
becomes the port's dict of tensors leaf by leaf, and back. A JAX adapter
pack's host master carries across the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from picotron_tpu_torch.inference.tenancy import AdapterPack
from picotron_tpu_torch.ops.quant_matmul import is_quant_weight
from picotron_tpu_torch.train_step import param_leaves


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: JAX hands out an ml_dtypes array, whose
        # bits are torch's bfloat16 bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: dict, device=None,
                    dtype: torch.dtype | None = None) -> dict[str, Any]:
    """A JAX parameter tree of numpy arrays -> the port's parameter dict
    (nested like the input), on ``device`` (default CPU), cast to
    ``dtype`` when given. A quantized leaf pair ``{"q": int8, "s": fp32}``
    (``llama.quantize_params``) is one leaf, not a subtree to cast: its
    tensors keep their dtypes whatever ``dtype`` asks for."""
    device = torch.device(device if device is not None else "cpu")
    if is_quant_weight(tree):
        return {k: _to_tensor(v, device, None) for k, v in tree.items()}
    return {k: (params_from_jax(v, device, dtype) if isinstance(v, dict)
                else _to_tensor(v, device, dtype))
            for k, v in tree.items()}


def params_to_jax(params: dict) -> dict[str, Any]:
    """The port's parameter dict -> a tree of numpy arrays for the JAX
    package. bf16 tensors come back as float32 (exact: every bf16 value
    is a float32 value), since numpy has no bf16 of its own; a quantized
    pair keeps its int8 values and fp32 scales."""
    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: (params_to_jax(v) if isinstance(v, dict) else conv(v))
            for k, v in params.items()}


def adapter_pack_from_jax(host_arrays: dict):
    """A JAX ``tenancy.AdapterPack``'s host master (its ``_host``: ``{leaf:
    (a [L, T, in, R], b [L, T, R, out])}`` numpy arrays) -> the port's
    ``AdapterPack`` holding the same slots, rank and values, so both
    packages serve one pack."""
    return AdapterPack.from_host(host_arrays)


def _adam_node(state):
    """The node of an optax state tree that holds Adam's ``mu``, ``nu``
    and ``count`` (``optax.chain(optax.adamw(...))`` nests it as
    ``((ScaleByAdamState, ...),)``)."""
    if {"mu", "nu", "count"} <= set(getattr(state, "_fields", ())):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _adam_node(sub)
            if found is not None:
                return found
    return None


def opt_state_from_jax(state, device=None,
                       dtype: torch.dtype | None = None) -> dict:
    """The JAX package's optimizer state (``train_step.init_state``'s
    ``optax.adamw`` state, fetched to numpy) -> the port's AdamW state
    ``{"count", "mu", "nu"}`` (moments as lists in ``param_leaves``
    order)."""
    adam = _adam_node(state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the given tree")
    return {"count": int(np.asarray(adam.count)),
            "mu": param_leaves(params_from_jax(adam.mu, device, dtype)),
            "nu": param_leaves(params_from_jax(adam.nu, device, dtype))}


def opt_state_to_jax(opt_state: dict, template):
    """The port's AdamW state -> the JAX package's state tree, shaped like
    ``template`` (a JAX optimizer state of the same parameters, fetched to
    numpy): its Adam node takes the moments and the count, and every
    other node that counts steps (the learning-rate schedule's) takes the
    count as well."""
    count = np.asarray(opt_state["count"], np.int32)

    def moments(like, flat):
        it = iter(flat)

        def fill(node):
            return {k: (fill(v) if isinstance(v, dict)
                        else params_to_jax({"x": next(it)})["x"])
                    for k, v in sorted(node.items())}

        return fill(like)

    def rebuild(node):
        fields = getattr(node, "_fields", None)
        if fields is None:
            return (tuple(rebuild(sub) for sub in node)
                    if isinstance(node, tuple) else node)
        if "mu" in fields:
            return node._replace(count=count,
                                 mu=moments(node.mu, opt_state["mu"]),
                                 nu=moments(node.nu, opt_state["nu"]))
        return node._replace(count=count) if "count" in fields else node

    return rebuild(template)
