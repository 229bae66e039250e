"""Linear-algebra ops (twin of ``incubator_mxnet_tpu/ops/la.py``; ref:
src/operator/tensor/la_op.cc, the LAPACK bridge ops ``_linalg_*``, and
contrib/krprod.h): the ten ``_linalg_*`` ops with their ``linalg_*``
aliases, and ``khatri_rao``.  They run on ``torch.linalg`` (cuSOLVER
and cuBLAS on the card, LAPACK on the CPU), batched over leading axes.

The JAX package's conventions hold, not LAPACK's: ``trmm`` multiplies
by the whole of ``A`` and ignores ``lower``; ``syevd`` returns the
eigenvectors as rows, then the eigenvalues, of the symmetrised input;
``gelqf`` returns ``(L, Q)`` from the QR factorisation of ``A``'s
transpose.  Eigenvector and QR signs are the library's, and may differ
between LAPACK and cuSOLVER.
"""
import torch

from .registry import defop


def _t(x):
    return x.transpose(-1, -2)


def _solve_lower(A, B, lower):
    """``solve_triangular(A, B, lower=lower)``: only the named triangle
    of ``A`` is read."""
    return torch.linalg.solve_triangular(A, B, upper=not lower)


@defop("_linalg_gemm", aliases=["linalg_gemm"])
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@defop("_linalg_gemm2", aliases=["linalg_gemm2"])
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@defop("_linalg_potrf", aliases=["linalg_potrf"])
def linalg_potrf(A):
    """Cholesky factor (lower) (ref: la_op.cc potrf)."""
    return torch.linalg.cholesky(A)


@defop("_linalg_potri", aliases=["linalg_potri"])
def linalg_potri(A):
    """Inverse from Cholesky factor: inv(L L^T)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    linv = _solve_lower(A, eye, True)
    return torch.matmul(_t(linv), linv)


@defop("_linalg_trmm", aliases=["linalg_trmm"])
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(A) B`` (or ``B op(A)``) with the WHOLE of ``A``:
    ``lower`` is ignored, as in the JAX package (ROADMAP records it)."""
    a = _t(A) if transpose else A
    out = torch.matmul(B, a) if rightside else torch.matmul(a, B)
    return alpha * out


@defop("_linalg_trsm", aliases=["linalg_trsm"])
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    if rightside:
        if transpose:
            # solve X A^T = alpha B  ->  A X^T = alpha B^T
            xt = _solve_lower(A, _t(B), lower)
        else:
            # solve X A = alpha B  ->  A^T X^T = alpha B^T
            xt = _solve_lower(_t(A), _t(B), not lower)
        return alpha * _t(xt)
    if transpose:
        # A^T X = alpha B, reading the named triangle of A
        return alpha * _solve_lower(_t(A), B, not lower)
    return alpha * _solve_lower(A, B, lower)


@defop("_linalg_sumlogdiag", aliases=["linalg_sumlogdiag"])
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@defop("_linalg_syrk", aliases=["linalg_syrk"])
def linalg_syrk(A, transpose=False, alpha=1.0):
    a = _t(A) if transpose else A
    return alpha * torch.matmul(a, _t(a))


@defop("_linalg_syevd", aliases=["linalg_syevd"], num_outputs=2)
def linalg_syevd(A):
    """(eigenvectors as rows, eigenvalues ascending) of (A + A^T) / 2."""
    w, v = torch.linalg.eigh((A + _t(A)) / 2)
    return _t(v), w


@defop("_linalg_gelqf", aliases=["linalg_gelqf"], num_outputs=2)
def linalg_gelqf(A):
    """LQ factorization via QR of A^T (ref: la_op.cc gelqf)."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    return _t(r), _t(q)


@defop("khatri_rao", variadic=True)
def khatri_rao(*args):
    """Column-wise Khatri-Rao product (ref: contrib/krprod.h)."""
    out = args[0]
    for b in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, b).reshape(
            (-1, out.shape[-1]))
    return out
