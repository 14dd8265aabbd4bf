# -*- coding: utf-8 -*-
"""The tiled Cholesky and inverse of ``csrc/tile_chol.cuh``, on the CPU.

The CUDA kernel (``csrc/dense_spine.cu``) runs only on the card.  Here a
plain PyTorch model of its algorithm, in float64 and in the kernel's order
of tile operations, is held to ``ops/dense_mxu.spine_torch`` (one
``cholesky_ex`` and a triangular solve) at rtol 1e-10:

  * per panel j of 8 (16 x 16 tiles of a 128 x 128 block): the diagonal
    tile factored and inverted pivot by pivot (the warp's in-register
    step: L's column scaled, the rank-1 update, the same step of the
    forward substitution L x = I), then the panel L_ij = A_ij T_jj^T, then
    the trailing update A_ik -= L_ij L_kj^T;
  * the inverse in place, block column j from the right:
    T_ij = -(sum_{k=j+1..i} T_ik L_kj) T_jj.

``factor_invert_tiles`` takes any multiple of 16 up to 256, as the kernel
does; ``tests/test_torch_dense_tiles.py`` builds on it.

A chain with a pivot that is not positive gives NaN in T and logdet, and
only that chain.
"""

import numpy as np
import pytest
import torch

from george_tpu_torch.ops import dense_mxu

SIDE = 16


def _spd_blocks(B, seed, ridge=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, dense_mxu.PANEL, dense_mxu.PANEL + 32))
    return (x @ x.transpose(0, 2, 1) / x.shape[2]
            + ridge * np.eye(dense_mxu.PANEL))


def _diag(D):
    """The diagonal tile's in-register step: (T = L^-1, log-pivots, ok)."""
    a = D.clone()
    x = torch.eye(SIDE, dtype=D.dtype).repeat(D.shape[0], 1, 1)
    rows = torch.arange(SIDE)
    logdet = torch.zeros(D.shape[0], dtype=D.dtype)
    ok = torch.ones(D.shape[0], dtype=torch.bool)
    for p in range(SIDE):
        d = a[:, p, p].clone()
        ok &= d > 0
        logdet += torch.log(d)
        inv = 1.0 / torch.sqrt(d)
        l = a[:, :, p] * inv[:, None]
        a -= l[:, :, None] * l[:, None, :]
        x[:, p, :] *= inv[:, None]
        m = torch.where(rows > p, l, torch.zeros_like(l))
        x -= m[:, :, None] * x[:, p, None, :]
    return x, logdet, ok


def factor_invert_tiles(S):
    """The blocked factor and inverse of (B, n, n) blocks (n a multiple of
    16, at most 256) by the kernel's tile steps: ({(i, j): T_ij}, logdet,
    ok)."""
    nb = S.shape[-1] // SIDE
    A = {(i, j): S[:, SIDE * i:SIDE * (i + 1), SIDE * j:SIDE * (j + 1)]
         .clone() for i in range(nb) for j in range(i + 1)}
    logdet = torch.zeros(S.shape[0], dtype=S.dtype)
    ok = torch.ones(S.shape[0], dtype=torch.bool)
    for j in range(nb):
        A[j, j], ld, good = _diag(A[j, j])
        logdet += ld
        ok &= good
        for i in range(j + 1, nb):
            A[i, j] = A[i, j] @ A[j, j].transpose(1, 2)
        for i in range(j + 1, nb):
            for k in range(j + 1, i + 1):
                A[i, k] = A[i, k] - A[i, j] @ A[k, j].transpose(1, 2)
    # The inverse, block column j from the right (every sum of the column
    # taken before any of its tiles is written).
    for j in range(nb - 2, -1, -1):
        P = {i: sum(A[i, k] @ A[k, j] for k in range(j + 1, i + 1))
             for i in range(j + 1, nb)}
        for i, Pi in P.items():
            A[i, j] = -(Pi @ A[j, j])
    return A, logdet, ok


def tile_model(S):
    """(T, logdet) of (B, 128, 128) blocks by the kernel's tile steps."""
    A, logdet, ok = factor_invert_tiles(S)
    T = torch.zeros_like(S)
    for (i, j), t in A.items():
        T[:, SIDE * i:SIDE * (i + 1), SIDE * j:SIDE * (j + 1)] = t
    nan = torch.tensor(float("nan"), dtype=S.dtype)
    return (torch.where(ok[:, None, None], T, nan),
            torch.where(ok, logdet, nan))


@pytest.mark.parametrize("ridge", [0.05, 1e-4])
def test_tile_model_matches_spine_torch(ridge):
    S = _spd_blocks(64, seed=11, ridge=ridge)
    S[5, 64, 64] = -1.0       # a negative pivot at 64
    S[40, 0, 0] = 0.0         # a zero first pivot
    S = torch.as_tensor(S)
    T, ld = tile_model(S)
    T_ref, ld_ref = dense_mxu.spine_torch(S)
    bad = torch.isnan(ld_ref)
    assert bad.nonzero().flatten().tolist() == [5, 40]
    assert torch.equal(torch.isnan(ld), bad)
    assert bool(torch.all(torch.isnan(T[bad])))
    ok = ~bad
    assert bool(torch.all(torch.isfinite(T[ok])))
    scale = T_ref[ok].abs().amax(dim=(1, 2), keepdim=True)
    assert float(((T[ok] - T_ref[ok]).abs() / scale).max()) <= 1e-10
    np.testing.assert_allclose(ld[ok].numpy(), ld_ref[ok].numpy(),
                               rtol=1e-10)
    # Zeros above the diagonal, exactly.
    upper = torch.ones(128, 128, dtype=torch.bool).triu(1)
    assert bool(torch.all(T[ok][:, upper] == 0))


def test_diagonal_step_is_the_tile_factor_and_inverse():
    D = torch.as_tensor(_spd_blocks(8, seed=12)[:, :SIDE, :SIDE])
    T, ld, ok = _diag(D)
    L = torch.linalg.cholesky(D)
    eye = torch.eye(SIDE, dtype=D.dtype).expand_as(D)
    assert bool(torch.all(ok))
    np.testing.assert_allclose(
        T.numpy(), torch.linalg.solve_triangular(L, eye, upper=False).numpy(),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), torch.logdet(D).numpy(),
                               rtol=1e-12)


# -- the batched A B^T's 3xTF32 split (csrc/batched_mmT.cu, float32) ---------

def _tf32_round(x):
    """x (float32) rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero: the kernel's hi (two integer operations on the bits)."""
    u = x.numpy().view(np.uint32)
    return torch.from_numpy(((u + np.uint32(0x1000)) & np.uint32(0xffffe000))
                            .view(np.float32))


def _tf32_cut(x):
    """x cut to TF32 as the tensor core reads a float32 operand."""
    u = x.numpy().view(np.uint32) & np.uint32(0xffffe000)
    return torch.from_numpy(u.view(np.float32))


def _mma_steps(pairs, k_step=8):
    """The kernel's float32 accumulation: per 8-deep step, the products of
    each (a, b) pair in turn into a fragment rounded to float32 after each
    (one m16n8k8 each), that fragment added to the float32 accumulator."""
    acc = None
    for k in range(0, pairs[0][0].shape[2], k_step):
        d = None
        for a, b in pairs:
            p = torch.einsum("bik,bjk->bij", a[:, :, k:k + k_step].double(),
                             b[:, :, k:k + k_step].double())
            d = (p if d is None else d.double() + p).float()
        acc = d if acc is None else acc + d
    return acc


def test_3xtf32_split_meets_the_float32_gate():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((16, 128, 128)),
                        dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((16, 128, 128)),
                        dtype=torch.float32)
    ref = torch.einsum("bik,bjk->bij", a.double(), b.double())
    scale = (torch.linalg.norm(a.double(), dim=2)[:, :, None]
             * torch.linalg.norm(b.double(), dim=2)[:, None, :])
    ulp = float(np.finfo(np.float32).eps)
    ahi, bhi = _tf32_round(a), _tf32_round(b)
    alo, blo = _tf32_cut(a - ahi), _tf32_cut(b - bhi)
    assert torch.equal(ahi + (a - ahi), a)          # the split is exact
    out = _mma_steps([(alo, bhi), (ahi, blo), (ahi, bhi)])
    err = float(((out.double() - ref).abs() / scale).max()) / ulp
    assert err <= 16, err                            # chip_smoke's MM_ULPS
    # One TF32 pass is far outside the gate: the split is what meets it.
    one = _mma_steps([(ahi, bhi)])
    assert float(((one.double() - ref).abs() / scale).max()) / ulp > 100
