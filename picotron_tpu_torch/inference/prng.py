"""Counter-based random numbers: the threefry-2x32 draws of ``jax.random``.

The per-slot key schedule (``inference.key_schedule: "slot"``) keys the
token at sequence index ``p`` of a request by ``fold_in(base, p - 1)``,
where ``base`` is one ``split`` of a ``PRNGKey(seed)`` chain per admitted
request. A stream is then a function of the base key, the positions and
the logits, whatever rounds the tokens were made in. This module is the
port's own copy of the parts of ``jax.random`` that schedule uses, with
the same bits: ``PRNGKey``, ``split``, ``fold_in``, 32-bit ``bits``, the
uniform on ``[minval, maxval)``, Gumbel noise and ``categorical``
(``jax_threefry_partitionable`` on, the JAX package's setting: the
counter of element ``i`` of a draw is the 64-bit pair ``(0, i)``).

A key is two uint32 words. Here a key, or a batch of them ``[..., 2]``,
is an int64 tensor holding those words, so the hash runs as int64 torch
ops on the key's device with every word masked back to 32 bits; host
keys (numpy uint32) convert with ``as_key``.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the smallest normal float32: the uniform's floor in ``gumbel``
_TINY = float(np.finfo(np.float32).tiny)


def as_key(key, device=None) -> torch.Tensor:
    """A key (or a batch of keys ``[..., 2]``) as the int64 tensor this
    module computes on: numpy uint32, Python ints or a tensor."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device or key.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=device)


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x0,
    x1)`` under the key ``(k0, k1)``; int64 tensors of 32-bit words that
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key: ``[num, 2]``."""
    key = as_key(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``keys [..., 2]`` and ``data``
    (uint32 values) broadcasting to ``[...]`` -> keys ``[..., 2]``."""
    keys = as_key(keys)
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _MASK
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([b0, b1], dim=-1)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of ``keys [B,
    2]``: ``[B, n]`` int64 holding uint32 values, element ``i`` the xor of
    the two words of the hash of counter ``(0, i)``."""
    keys = as_key(keys)
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b0, b1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo),
                          lo)
    return b0 ^ b1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for each
    key of ``keys [B, 2]``: the top 23 bits of ``bits`` as the mantissa of
    a float in [1, 2), less 1, scaled and floored at ``minval``. ``[B, n]``
    float32."""
    mant = (bits(keys, n) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars on the host: a CUDA op takes a 0-d CPU tensor as a
    # scalar operand, with no copy to the device (which would wait for it)
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (its default "low" mode)
    for each key of ``keys [B, 2]``: ``-log(-log(u))`` of the uniform on
    [tiny, 1). ``[B, n]`` float32."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` of each row of ``logits [B, V]`` with its
    own key of ``keys [B, 2]``: the argmax of Gumbel noise plus the
    logits (the first index on a tie). ``[B]`` int64."""
    g = gumbel(keys.to(logits.device), logits.shape[-1])
    return torch.argmax(g + logits.float(), dim=-1)
