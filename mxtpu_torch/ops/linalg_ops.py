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

``dot`` with a CSR left operand (a ``torch.sparse_csr`` tensor, what a
CSR array feeds a graph) computes from the compressed tensors under
:class:`CsrDot`: a gather of the right operand's rows by the stored
columns and an ``index_add_`` by row, forward and backward, so no dense
(rows, columns) operand is made. ``mxtpu`` computes the same product as
one dense ``jnp.matmul`` (its CSR arrays are dense-backed).
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x):
    """``x`` with its last two axes swapped (a 1-d array as it is)."""
    return x.transpose(-1, -2) if x.dim() >= 2 else x


def csr_row_ids(crow, nnz):
    """The row of each stored entry of a CSR matrix with row pointers
    ``crow`` and ``nnz`` entries (the output size given, so no host
    read)."""
    counts = crow[1:] - crow[:-1]
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=crow.device), counts,
        output_size=nnz)


class CsrDot(torch.autograd.Function):
    """``csr @ rhs`` (or ``csr.T @ rhs`` with ``transpose_a``) from the
    CSR matrix's ``values``, ``rows`` (each entry's row, from
    :func:`csr_row_ids`) and ``cols``: each stored entry scales the
    ``rhs`` row it names, and the products are summed into their output
    rows by ``index_add_``. The backward for ``rhs`` is the same sum the
    other way round; the CSR values take no gradient, as in MXNet."""

    @staticmethod
    def forward(ctx, values, rows, cols, rhs, out_rows, transpose_a):
        src, dst = (rows, cols) if transpose_a else (cols, rows)
        flat = rhs.reshape(rhs.shape[0], -1)
        scale = values.to(flat.dtype).unsqueeze(1)
        out = flat.new_zeros((out_rows, flat.shape[1]))
        out.index_add_(0, dst, flat.index_select(0, src) * scale)
        ctx.save_for_backward(scale, src, dst)
        ctx.rhs_shape = rhs.shape
        return out.reshape((out_rows,) + tuple(rhs.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        scale, src, dst = ctx.saved_tensors
        if not ctx.needs_input_grad[3]:
            return None, None, None, None, None, None
        g = grad.reshape(grad.shape[0], -1)
        d_rhs = g.new_zeros((ctx.rhs_shape[0], g.shape[1]))
        d_rhs.index_add_(0, src, g.index_select(0, dst) * scale)
        return None, None, None, d_rhs.reshape(ctx.rhs_shape), None, None


def csr_dot(csr, rhs, transpose_a=False):
    """``csr @ rhs`` (``csr.T @ rhs`` with ``transpose_a``) for a
    ``torch.sparse_csr`` matrix ``csr`` and a dense ``rhs`` whose first
    axis the product contracts, through :class:`CsrDot`."""
    values, cols = csr.values(), csr.col_indices()
    rows = csr_row_ids(csr.crow_indices(), cols.numel())
    out_rows = csr.shape[1] if transpose_a else csr.shape[0]
    return CsrDot.apply(values, rows, cols, rhs, out_rows, transpose_a)


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``lhs`` contracted with the first of
    ``rhs`` (``tensordot``), after swapping each one's last two axes
    where asked; two vectors give their inner product. A CSR ``lhs``
    (``torch.sparse_csr``) goes through :func:`csr_dot`."""
    if lhs.layout == torch.sparse_csr:
        return csr_dot(lhs, _t(rhs) if transpose_b else rhs, transpose_a)
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
