"""Kernels A and D of the PyTorch port (RMSNorm forward and backward): their
launch plans and the order in which D sums dw, on the CPU.

The CUDA kernels (``csrc/rmsnorm.cu``) run only on the card, where
``chip_smoke.py`` holds them to their plain versions. Here:

- ``plan_fwd`` and ``plan_bwd`` are functions of their arguments alone, at
  every shape the chip smoke runs and at edges (one row, fewer rows than
  SMs, ragged H, the loop variants past H 16384); every row goes to exactly
  one warp group, every column vector to exactly one lane, and D's column
  slices and segments cover H and the grid exactly once;
- ``rms_norm_bwd_fixed_order_plain`` (D's dw summed in the plan's order)
  agrees with ``rms_norm_bwd_plain`` and with ``jax.vjp`` of the JAX
  package's plain ``rms_norm`` on numpy inputs from a seed, and follows the
  plan step for step (an independent numpy walk gives the same bits);
- a tensor that reports a CUDA device never reaches a plain version: with
  the kernel library unavailable every entry raises and counts no launch.
"""

from __future__ import annotations

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu.ops.rmsnorm import rms_norm as jax_rms_norm
from picotron_tpu_torch.ops.kernels import rmsnorm as ka

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_LIMIT = 227 * 1024 - 1024  # a block's dynamic shared memory, less static


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Keep torch to one thread beside the other test workers, and restore
    the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fwd_shapes():
    cs = _chip_smoke()
    return sorted(set(cs.A_SHAPES) | {(1, 2048), (1, 8), (3, 1000),
                                     (131, 2048), (1025, 4096), (2, 16384),
                                     (5, 16392), (2, 40000)})


def _bwd_shapes():
    cs = _chip_smoke()
    return sorted(set(cs.D_SHAPES) | {(1, 2048), (1, 8), (7, 1000),
                                     (131, 2048), (133, 2048), (9, 3072),
                                     (3, 16384), (5, 16392), (2, 40000)})


# --------------------------------------------------------------------------- #
# the plans
# --------------------------------------------------------------------------- #


def test_plan_fwd_is_a_function_of_the_shapes_and_covers_each_row_once():
    """A: the same plan for the same shapes, whatever was asked before;
    the groups' walks cover each row once and no block is left without a
    row; a group's lanes own each of the row's 16-byte vectors once."""
    shapes = _fwd_shapes()
    first = {s: dict(ka.plan_fwd(*s)) for s in shapes}
    ka.plan_fwd.cache_clear()
    for s in reversed(shapes):
        assert ka.plan_fwd(*s) == first[s], s
    for rows, H in shapes:
        p = ka.plan_fwd(rows, H)
        nvec = H // ka.VEC
        G, vpl, W = p["warps_per_row"], p["vec_per_lane"], p["warps"]
        assert 1 <= W <= 8 and W % G == 0
        gpb = W // G
        assert p["groups"] == p["blocks"] * gpb
        walked = [r for k in range(p["groups"])
                  for r in ka.rows_of(p, rows, k)]
        assert sorted(walked) == list(range(rows))
        assert (p["blocks"] - 1) * gpb < rows  # no block without a row
        assert p["blocks"] <= ka.FWD_MAX_BLOCKS or p["variant"] == "loop"
        if p["variant"] == "loop":
            assert vpl == 0 and G == 1 and H > 16384
            continue
        assert vpl in (1, 2, 4, 8) and G in (1, 2, 4, 8)
        vecs = [(gw * vpl + i) * 32 + lane for gw in range(G)
                for i in range(vpl) for lane in range(32)]
        assert len(set(vecs)) == len(vecs)
        assert set(range(nvec)) <= set(vecs)
        assert max(vecs) < nvec + 32 * vpl  # no warp without a vector
    # decode's and a prefill chunk's rows over four warps each, many rows
    # over two
    assert ka.plan_fwd(8, 2048)["warps_per_row"] == 4
    assert ka.plan_fwd(512, 2048)["warps_per_row"] == 4
    assert ka.plan_fwd(8192, 2048)["warps_per_row"] == 2
    assert ka.plan_fwd(8192, 4096)["warps_per_row"] == 2


@pytest.mark.parametrize("sms", [132, 7, 1])
def test_plan_bwd_is_a_function_of_its_arguments_and_covers_once(sms):
    """D: the same plan for the same (rows, H, SMs); at most one block an
    SM and none without a row; every row walked by exactly one group, in
    increasing order; each column vector owned by one lane of a group;
    the blocks' column slices cover H exactly once and the segments the
    grid; the shared memory a block asks for fits."""
    shapes = _bwd_shapes()
    first = {s: dict(ka.plan_bwd(*s, sms)) for s in shapes}
    ka.plan_bwd.cache_clear()
    for s in reversed(shapes):
        assert ka.plan_bwd(*s, sms) == first[s], s
    for rows, H in shapes:
        p = ka.plan_bwd(rows, H, sms)
        nvec = H // ka.VEC
        gpb, W = p["groups_per_block"], p["warps"]
        assert p["groups"] == p["blocks"] * gpb
        assert 1 <= p["blocks"] <= min(sms, rows)
        walked = [r for k in range(p["groups"])
                  for r in ka.rows_of(p, rows, k)]
        assert sorted(walked) == list(range(rows))
        for k in range(p["groups"]):
            walk = list(ka.rows_of(p, rows, k))
            assert walk == sorted(walk)
        assert all(ka.rows_of(p, rows, b * gpb)
                   for b in range(p["blocks"]))
        cols = [c for c0, c1 in ka.bwd_column_slices(p, H)
                for c in range(c0, c1)]
        assert cols == list(range(H))
        assert p["slice_cols"] % 4 == 0
        assert len(ka.bwd_column_slices(p, H)) == p["blocks"]
        segs = ka.bwd_segments(p)
        assert [b for b0, b1 in segs for b in range(b0, b1)] == \
            list(range(p["blocks"]))
        assert len(segs) <= W * 32 and p["segment_blocks"] <= \
            math.isqrt(p["blocks"] - 1) + 1
        if p["variant"] == "loop":
            assert p["vec_per_lane"] == 0 and gpb == 1 and H > 16384
            continue
        G, vpl = p["warps_per_row"], p["vec_per_lane"]
        assert G * gpb == W and vpl in (1, 2, 4, 8)
        vecs = [(gw * vpl + i) * 32 + lane for gw in range(G)
                for i in range(vpl) for lane in range(32)]
        assert len(set(vecs)) == len(vecs) and set(range(nvec)) <= set(vecs)
        ring = W * 3 * 2 * vpl * 32 * 16  # three rows a warp's ring
        columns = gpb * -(-nvec // 32) * 8 * 36 * 4
        assert max(ring, columns) <= SMEM_LIMIT
    # the training shape: one warp a row, one block on each of 132 SMs
    p = ka.plan_bwd(8192, 2048, 132)
    assert (p["blocks"], p["warps_per_row"], p["vec_per_lane"]) == (132, 1, 8)
    assert ka.plan_bwd(4096, 4096, 132)["warps_per_row"] == 2


# --------------------------------------------------------------------------- #
# D's order of summation
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,H,sms", [(37, 1000, 132), (300, 64, 7),
                                        (20, 4096, 3), (1, 2048, 132),
                                        (5, 16392, 2)])
def test_bwd_fixed_order_matches_plain_and_jax_vjp(rows, H, sms, dtype):
    """D's dx and dw (dw summed in the plan's order) against
    ``rms_norm_bwd_plain`` and ``jax.vjp`` of the JAX package's plain
    ``rms_norm``, at the tolerances of
    ``test_rmsnorm_backward_matches_jax_vjp``: fp32 1e-5; bf16 2^-7 (two
    bf16 rounding steps of the outputs), dw's atol 30 times that (a sum
    over the rows). In bf16 the vjp runs in fp32 on the same bf16 values:
    run in bf16 it sums dw in bf16, which at 300 rows strays by 0.5 from
    both the plain version and this order."""
    rng = np.random.default_rng(rows * 7 + H)
    eps = 1e-5
    x = rng.standard_normal((rows, H)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    dy = rng.standard_normal((rows, H)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tx, tw, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    jx, jw, jdy = (jnp.asarray(t.float().numpy()) for t in (tx, tw, tdy))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    plan = ka.plan_bwd(rows, H, sms)
    dx, dw = ka.rms_norm_bwd_fixed_order_plain(tx, tw, tdy, eps, plan)
    pdx, pdw = ka.rms_norm_bwd_plain(tx, tw, tdy, eps)
    _, vjp = jax.vjp(lambda a, b: jax_rms_norm(a, b, eps), jx, jw)
    jdx, jdw = (np.asarray(g, np.float32) for g in vjp(jdy))
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    assert dx.shape == tx.shape and dw.shape == tw.shape
    dw_tol = dict(rtol=tol["rtol"], atol=tol["atol"] * 30)
    for want_dx, want_dw in ((pdx.float().numpy(), pdw.float().numpy()),
                             (jdx, jdw)):
        np.testing.assert_allclose(dx.float().numpy(), want_dx, **tol)
        np.testing.assert_allclose(dw.float().numpy(), want_dw, **dw_tol)


@pytest.mark.parametrize("rows,H,sms", [(37, 1000, 132), (300, 64, 7),
                                        (20, 4096, 3), (5, 16392, 2)])
def test_bwd_fixed_order_follows_the_plan_step_by_step(rows, H, sms):
    """The emulation's fp32 dw, bit for bit, against a numpy walk of the
    same order written from the plan's fields alone: block b's group j is
    group b * groups_per_block + j and walks rows k, k + groups, ...; a
    block adds its groups in order; each column's partial rows are added
    in block order inside segments of segment_blocks blocks, then the
    segments in order."""
    rng = np.random.default_rng(rows + H)
    eps = 1e-5
    x = torch.from_numpy(rng.standard_normal((rows, H)).astype(np.float32))
    w = torch.ones(H)
    dy = torch.from_numpy(rng.standard_normal((rows, H)).astype(np.float32))
    p = ka.plan_bwd(rows, H, sms)
    _, dw = ka.rms_norm_bwd_fixed_order_plain(x, w, dy, eps, p)
    x32 = x.numpy()
    r = 1.0 / np.sqrt((x32 * x32).mean(-1, keepdims=True) + eps)
    xhat = torch.from_numpy(x32) * torch.rsqrt(
        (x * x).mean(dim=-1, keepdim=True) + eps)
    contrib = (dy * xhat).numpy()
    assert np.allclose(xhat.numpy(), x32 * r, rtol=1e-5)
    nb, gpb, groups = p["blocks"], p["groups_per_block"], p["groups"]
    partial = np.zeros((nb, H), np.float32)
    for b in range(nb):
        for j in range(gpb):
            acc = np.zeros(H, np.float32)
            for row in range(b * gpb + j, rows, groups):
                acc = (acc + contrib[row]).astype(np.float32)
            partial[b] = acc if j == 0 else (partial[b] + acc)
    sb, cw = p["segment_blocks"], p["slice_cols"]
    want = np.zeros(H, np.float32)
    for b in range(nb):
        c0, c1 = min(H, b * cw), min(H, (b + 1) * cw)
        total = None
        for s0 in range(0, nb, sb):
            seg = partial[s0, c0:c1].copy()
            for bb in range(s0 + 1, min(nb, s0 + sb)):
                seg = (seg + partial[bb, c0:c1]).astype(np.float32)
            total = seg if total is None else (total + seg)
        want[c0:c1] = total
    np.testing.assert_array_equal(dw.numpy(), want)


# --------------------------------------------------------------------------- #
# the CUDA path never falls back
# --------------------------------------------------------------------------- #


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper's CUDA
    path on a machine without a card, up to the kernel library."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def test_rmsnorm_on_a_cuda_tensor_never_reaches_the_plain_versions(
        monkeypatch):
    """A CUDA tensor goes to kernel A or D or raises: with the library
    unavailable the forward, the backward and the forward under autograd
    all raise, neither plain version is called and no launch is
    counted."""
    def boom(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(ka, "rms_norm_plain", boom)
    monkeypatch.setattr(ka, "rms_norm_bwd_plain", boom)
    monkeypatch.setattr(ka, "rms_norm_bwd_fixed_order_plain", boom)
    monkeypatch.setattr(ka.build, "library", no_library)
    monkeypatch.setattr(ka, "sm_count", lambda index: 132)

    def cuda(t):
        return t.as_subclass(_CudaLooking)

    x = cuda(torch.zeros(4, 64, dtype=torch.bfloat16))
    w = cuda(torch.ones(64, dtype=torch.bfloat16))
    before = (ka.KERNEL.launches, ka.KERNEL_BWD.launches)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        ka.rms_norm(x, w)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        ka.rms_norm_fwd(x, w)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        ka.rms_norm_bwd(x, w, x)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        ka.rms_norm(x.clone().requires_grad_(True), w)
    with pytest.raises(ValueError, match="bf16"):  # checked before the build
        ka.rms_norm_bwd(cuda(torch.zeros(4, 64)), w, x)
    assert (ka.KERNEL.launches, ka.KERNEL_BWD.launches) == before
    assert ka.SCRATCH == {} or all(
        t.device.type == "cuda" for t in ka.SCRATCH.values())
