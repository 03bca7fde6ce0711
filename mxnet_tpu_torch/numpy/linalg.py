"""``mx.np.linalg`` — linear algebra (counterpart of
``mxnet_tpu/numpy/linalg.py``): the reference's 21 names, each over
``torch.linalg`` on the array's device, dispatched as the ``mx.np`` ops
are (autograd records every name but ``matrix_rank``)."""
from __future__ import annotations

import torch

from . import _T, _fl, _wrap

__all__ = []

_NONDIFF_LA = {"matrix_rank"}


def _norm(x, ord=None, axis=None, keepdims=False):
    x = _fl(_T(x))
    if isinstance(axis, list):
        axis = tuple(axis)
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    a = _fl(_T(a))
    if not compute_uv:
        return torch.linalg.svdvals(a)
    return tuple(torch.linalg.svd(a, full_matrices=full_matrices))


def _qr(a, mode="reduced"):
    q, r = torch.linalg.qr(_fl(_T(a)), mode="r" if mode == "r" else
                           ("complete" if mode == "complete" else
                            "reduced"))
    return r if mode == "r" else (q, r)


def _lstsq(a, b, rcond=None):
    # numpy's four results (solution, residuals, rank, singular
    # values), through the pseudo-inverse on every device
    a, b = _fl(_T(a)), _fl(_T(b, _T(a)))
    x = torch.linalg.pinv(a) @ b
    s = torch.linalg.svdvals(a)
    rank = torch.linalg.matrix_rank(a).to(torch.int32)
    m, n = a.shape[-2], a.shape[-1]
    if m > n and int(rank) == n:
        r = a @ x - b
        res = (r * r).sum(0).reshape(-1 if b.dim() > 1 else 1)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return x, res, rank, s


def _slogdet(a):
    sign, logabs = torch.linalg.slogdet(_fl(_T(a)))
    return sign, logabs


def _matrix_rank(M, tol=None, hermitian=False, rtol=None):
    M = _fl(_T(M))
    return torch.linalg.matrix_rank(M, atol=tol, rtol=rtol,
                                    hermitian=hermitian).to(torch.int32)


def _multi_dot(arrays, *, out=None):
    ts = [_fl(_T(a)) for a in arrays]
    return torch.linalg.multi_dot(ts)


_FNS = {
    "norm": _norm, "svd": _svd,
    "svdvals": lambda x: torch.linalg.svdvals(_fl(_T(x))),
    "cholesky": lambda a, upper=False: torch.linalg.cholesky(
        _fl(_T(a)), upper=upper),
    "qr": _qr,
    "inv": lambda a: torch.linalg.inv(_fl(_T(a))),
    "pinv": lambda a, rcond=None, hermitian=False, rtol=None:
        torch.linalg.pinv(_fl(_T(a)), hermitian=hermitian,
                          rtol=rtol if rtol is not None else rcond),
    "det": lambda a: torch.linalg.det(_fl(_T(a))),
    "slogdet": _slogdet,
    "solve": lambda a, b: torch.linalg.solve(_fl(_T(a)),
                                             _fl(_T(b, _T(a)))),
    "lstsq": _lstsq,
    "eig": lambda a: tuple(torch.linalg.eig(_fl(_T(a)))),
    "eigh": lambda a, UPLO="L", symmetrize_input=True: tuple(
        torch.linalg.eigh(_fl(_T(a)), UPLO=UPLO)),
    "eigvals": lambda a: torch.linalg.eigvals(_fl(_T(a))),
    "eigvalsh": lambda a, UPLO="L", symmetrize_input=True:
        torch.linalg.eigvalsh(_fl(_T(a)), UPLO=UPLO),
    "matrix_rank": _matrix_rank,
    "matrix_power": lambda a, n: torch.linalg.matrix_power(_T(a), n),
    "multi_dot": _multi_dot,
    "tensorinv": lambda a, ind=2: torch.linalg.tensorinv(_fl(_T(a)),
                                                         ind=ind),
    "tensorsolve": lambda a, b, axes=None: torch.linalg.tensorsolve(
        _fl(_T(a)), _fl(_T(b, _T(a))), dims=axes),
    "cond": lambda x, p=None: torch.linalg.cond(_fl(_T(x)), p=p),
}

for _name, _fn in _FNS.items():
    globals()[_name] = _wrap(_name, _fn,
                             differentiable=_name not in _NONDIFF_LA,
                             export=False)
    __all__.append(_name)
