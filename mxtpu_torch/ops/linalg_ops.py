"""Linear algebra ops of the PyTorch port.

Counterpart of ``mxtpu/ops/linalg_ops.py``: ``dot``, ``batch_dot``, the
LAPACK family of MXNet's ``src/operator/tensor/la_op.cc``
(``linalg_gemm``, ``gemm2``, ``potrf``, ``potri``, ``trsm``, ``trmm``,
``sumlogdiag``, ``syrk``, ``gelqf``, ``syevd``) and ``khatri_rao``.
``mxtpu`` computes them with ``jnp`` / ``jnp.linalg`` outside any Pallas
kernel, so here they are ``torch.matmul`` and ``torch.linalg`` (cuBLAS
and cuSOLVER on the card). Each takes a batch of matrices in its leading
axes. The factorizations' conventions are ``mxtpu``'s: ``gelqf`` is the
QR of the transpose (``torch.linalg.qr``, Householder as LAPACK's, so the
same signs), and ``syevd`` gives the eigenvectors as rows, eigenvalues
ascending, each row turned so that its largest entry is positive (so the
card and the CPU agree; ``jnp.linalg.eigh``'s sign is the solver's, so a
row of ``mxtpu``'s may be the port's negated).
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x):
    """``x`` with its last two axes swapped (a 1-d array as it is)."""
    return x.transpose(-1, -2) if x.dim() >= 2 else x


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``lhs`` contracted with the first of
    ``rhs`` (``tensordot``), after swapping each one's last two axes
    where asked; two vectors give their inner product."""
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """A matrix product for each leading index: (B, n, k) x (B, k, m)."""
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    return torch.matmul(a, b)


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """alpha * op(A) op(B) + beta * C."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """alpha * op(A) op(B)."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A):
    """The lower Cholesky factor L of A = L L^T."""
    return torch.linalg.cholesky(A)


@register("linalg_potri")
def linalg_potri(A):
    """(A A^T)^-1 from the lower-triangular factor A."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    inv_l = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(_t(inv_l), inv_l)


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """X with op(A) X = alpha B (or X op(A) = alpha B with
    ``rightside``), A triangular."""
    a = _t(A) if transpose else A
    low = (not lower) if transpose else lower
    return torch.linalg.solve_triangular(a, alpha * B, upper=not low,
                                         left=not rightside)


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """alpha * op(tri(A)) B (or B op(tri(A)) with ``rightside``)."""
    tri = torch.tril(A) if lower else torch.triu(A)
    a = _t(tri) if transpose else tri
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    """The sum of the logs of A's diagonal."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    """alpha * A A^T (A^T A with ``transpose``)."""
    if transpose:
        return alpha * torch.matmul(_t(A), A)
    return alpha * torch.matmul(A, _t(A))


@register("linalg_gelqf", num_outputs=2)
def linalg_gelqf(A):
    """The LQ factorisation A = L Q, Q with orthonormal rows: (L, Q)."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("linalg_syevd", num_outputs=2)
def linalg_syevd(A):
    """The eigendecomposition of symmetric A: (U, lambda) with
    A = U^T diag(lambda) U, eigenvalues ascending. Each row of U is
    turned so that its entry of largest magnitude is positive: the
    solver's sign differs between cuSOLVER and LAPACK (and from
    ``jnp.linalg.eigh``'s), this one does not."""
    w, v = torch.linalg.eigh(A)
    u = _t(v)
    peak = torch.gather(u, -1, u.abs().argmax(-1, keepdim=True))
    return u * torch.where(peak < 0, -1.0, 1.0).to(u.dtype), w


@register("khatri_rao")
def khatri_rao(*args):
    """The column-wise Kronecker product of matrices with equal column
    counts (MXNet's ``contrib/krprod.cc``)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out
