"""Batched tridiagonal solves on ``(Nz, cells)`` tensors (counterpart of
``terrarium_tpu/ops/tridiag.py``).

Both solve ``a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k]`` for every column,
``a[0]`` and ``c[-1]`` ignored, in the JAX package's arithmetic and order, and
are differentiable with torch autograd:

* :func:`tridiag_solve`: Thomas, a forward elimination and a back
  substitution row by row (the scan's ``fwd`` and ``bwd``);
* :func:`tridiag_solve_pcr`: parallel cyclic reduction, ``ceil(log2 Nz)``
  rounds over whole columns.

The CUDA column kernel (``csrc/soil_step.cuh``, ``soil::thomas`` and
``soil::pcr``) runs the same operations on a column in registers. JAX's
``THOMAS_UNROLL`` and ``tridiag_solve_pair_rows`` lay the same solve out for
the TPU's vector registers and have no counterpart here.
"""
from __future__ import annotations

import torch

__all__ = ["tridiag_solve", "tridiag_solve_pcr", "SOLVERS", "diffusion_rows"]


def tridiag_solve(a, b, c, d):
    """Thomas: ``c'[k] = c[k] / (b[k] - a[k] c'[k-1])``, ``d'[k] = (d[k] -
    a[k] d'[k-1]) / (b[k] - a[k] c'[k-1])`` from the bottom row up with
    ``a[0]`` taken as 0, then ``x[k] = d'[k] - c'[k] x[k+1]`` from the top
    down with ``x[Nz] = 0``."""
    n = b.shape[0]
    c_prev = d_prev = zero = torch.zeros_like(b[0])
    cs, ds = [], []
    for k in range(n):
        a_k = a[k] if k > 0 else zero
        denom = b[k] - a_k * c_prev
        c_prev = c[k] / denom
        d_prev = (d[k] - a_k * d_prev) / denom
        cs.append(c_prev)
        ds.append(d_prev)
    x_next, xs = zero, [None] * n
    for k in reversed(range(n)):
        x_next = ds[k] - cs[k] * x_next
        xs[k] = x_next
    return torch.stack(xs)


def _below(x, s, fill):
    """Row ``k`` of the result is ``x[k - s]``; rows ``k < s`` are ``fill``."""
    return torch.cat([torch.full_like(x[:s], fill), x[:-s]])


def _above(x, s, fill):
    """Row ``k`` of the result is ``x[k + s]``; rows ``k >= Nz - s`` are
    ``fill``."""
    return torch.cat([x[s:], torch.full_like(x[:s], fill)])


def tridiag_solve_pcr(a, b, c, d):
    """Parallel cyclic reduction of the same system. Rows out of range act
    as the identity (``b = 1``, ``a = c = d = 0``); each round, with stride
    ``s = 1, 2, 4, ...``, eliminates the couplings to rows ``k - s`` and
    ``k + s``, its new ``a`` and ``c`` built from the old ones."""
    n = b.shape[0]
    a = torch.cat([torch.zeros_like(a[:1]), a[1:]])
    c = torch.cat([c[:-1], torch.zeros_like(c[:1])])
    s = 1
    while s < n:
        alpha = -a / _below(b, s, 1.0)
        gamma = -c / _above(b, s, 1.0)
        b, d, a, c = (b + alpha * _below(c, s, 0.0) + gamma * _above(a, s, 0.0),
                      d + alpha * _below(d, s, 0.0) + gamma * _above(d, s, 0.0),
                      alpha * _below(a, s, 0.0),
                      gamma * _above(c, s, 0.0))
        s *= 2
    return d / b


#: the solvers of ``ImplicitEuler(solver=...)``
SOLVERS = {"thomas": tridiag_solve, "pcr": tridiag_solve_pcr}


def diffusion_rows(K_faces, D, scale, dz, dz_faces, dt, dirichlet_bottom=False,
                   dirichlet_top=False):
    """The rows ``(a, b, c)`` of ``(I/dt - J) du = rhs`` for the flux ``q =
    -K d(phi)/dz`` with face conductivities ``K_faces`` ``(Nz+1, cells)``,
    the chain factor ``D = d(phi)/d(u)`` ``(Nz, cells)`` and the tendency
    ``scale`` (`implicit.py:69-117`, in its order of operations): each face
    term is ``(s K D) / (dzf dz)``, the boundary rows take no term of their
    boundary face, and a Dirichlet ``phi`` adds ``2 s K D / (dzf dz)`` to its
    boundary row. ``dz`` ``(Nz, 1)`` and ``dz_faces`` ``(Nz+1, 1)``; ``scale``
    is 0-d or ``(Nz, cells)``."""
    Kf, s, dzf = K_faces, scale, dz_faces
    K_lo, K_hi, dzf_lo, dzf_hi = Kf[:-1], Kf[1:], dzf[:-1], dzf[1:]
    zero = torch.zeros_like(D[:1])
    a = -(s * K_lo * torch.cat([zero, D[:-1]]) / (dzf_lo * dz))
    c = -(s * K_hi * torch.cat([D[1:], zero]) / (dzf_hi * dz))
    diag_lo = torch.cat([zero, (s * K_lo * D / (dzf_lo * dz))[1:]])
    diag_hi = torch.cat([(s * K_hi * D / (dzf_hi * dz))[:-1], zero])
    b = 1.0 / dt + diag_lo + diag_hi
    if dirichlet_bottom:
        sb = s if s.dim() == 0 else s[:1]
        b = torch.cat([b[:1] + _boundary_term(sb, Kf[:1], D[:1], dzf[:1, :1], dz[:1, :1]),
                       b[1:]])
    if dirichlet_top:
        st = s if s.dim() == 0 else s[-1:]
        b = torch.cat([b[:-1], b[-1:] + _boundary_term(st, Kf[-1:], D[-1:], dzf[-1:, :1],
                                                        dz[-1:, :1])])
    return a, b, c


def _boundary_term(s, K, D, dzf, dz):
    return 2.0 * s * K * D / (dzf.reshape(()) * dz.reshape(()))
