"""Linear operators for the ADMM family.

Counterparts of :mod:`proxmin_tpu.linop`: a :class:`LinearOperator` wraps
``None`` (the identity), a dense matrix, a sparse matrix or a pair of
``matvec``/``rmatvec`` callables, and caches the spectral quantity the ADMM
step coupling needs. The JAX classes are pytrees so that they can flow into
``jit``; here they are plain classes of tensors.

Naming note, as in the JAX package: ``spectral_norm_sq`` (and its
reference-compatible alias ``spectral_norm``) is ``lambda_max(L^T L) =
||L||_s^2``, the quantity of ``step_g = step_f * ||L||_s^2 * N * M``.

Every constructor that makes tensors takes ``device=``. NumPy and
scipy.sparse inputs go to the CUDA device by default
(:func:`~proxmin_tpu_torch.solvers.common.default_device`); tensors stay
where they are unless ``device`` is given.
"""

import numpy as np
import torch

from .solvers.common import as_torch_dtype, default_device

__all__ = [
    "LinearOperator",
    "IdentityOperator",
    "MatrixOperator",
    "FunctionOperator",
    "SparseOperator",
    "as_linear_operator",
    "power_iteration_norm_sq",
    "lanczos_norm_sq",
    "gram_norm_sq",
    "MatrixAdapter",
    "get_spectral_norm",
]


def _start_vector(n, dtype, device):
    """The deterministic start vector of both iterations: normalized ones
    plus a non-uniform index perturbation, so that it is not orthogonal to
    the leading eigenvector even for structured operators."""
    v0 = torch.ones((n,), dtype=dtype, device=device)
    v0 = v0 + 0.01 * torch.arange(1, n + 1, dtype=dtype, device=device) / n
    return v0 / torch.linalg.norm(v0)


def power_iteration_norm_sq(matvec, rmatvec, shape, num_iters=64,
                            dtype=torch.float32, device=None):
    """``lambda_max(L^T L)`` for an implicit operator by power iteration.

    ``matvec: x -> L x`` with ``x`` of shape ``shape``. A fixed
    ``num_iters`` from a deterministic start vector; nothing is read back
    to the host. Returns the Rayleigh quotient ``v^T L^T L v`` as a 0-d
    tensor on ``device``."""
    dtype = as_torch_dtype(dtype)
    device = default_device(device)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    v = _start_vector(n, dtype, device)
    tiny = torch.finfo(dtype).tiny
    for _ in range(int(num_iters)):
        w = rmatvec(matvec(v.reshape(shape))).reshape(-1)
        v = w / torch.clamp_min(torch.linalg.norm(w), tiny)
    Lv = matvec(v.reshape(shape)).reshape(-1)
    return torch.dot(Lv, Lv).to(dtype)


def lanczos_norm_sq(matvec, rmatvec, shape, num_iters=64,
                    dtype=torch.float32, device=None):
    """``lambda_max(L^T L)`` for an implicit operator by fixed-size
    Lanczos.

    Power iteration converges like ``(lambda_2 / lambda_1)^k``, which is
    hopeless for operators with clustered top eigenvalues (finite
    differences: the gap is O(1/n^2)). ``k = min(num_iters, n)`` matvec
    pairs build a k x k tridiagonal whose top Ritz value bounds
    ``lambda_max`` tightly from below. No reorthogonalization (ghost
    eigenvalues only repeat converged ones, which cannot change the
    maximum). A breakdown (``beta = 0``: an invariant subspace) zeroes the
    remaining vectors and leaves the computed block, and its maximum,
    intact. The diagonals stay on the device and ``beta`` is never read on
    the host: the breakdown rule is a ``torch.where``."""
    dtype = as_torch_dtype(dtype)
    device = default_device(device)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    k = min(int(num_iters), n)

    def Av(v):
        return rmatvec(matvec(v.reshape(shape))).reshape(-1).to(dtype)

    v = _start_vector(n, dtype, device)
    tiny = torch.finfo(dtype).tiny
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas = torch.zeros((k,), dtype=dtype, device=device)
    betas = torch.zeros((k,), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for i in range(k):
        w = Av(v) - beta * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta = torch.linalg.norm(w)
        v_prev, v = v, torch.where(beta > tiny,
                                   w / torch.clamp_min(beta, tiny), zero)
        alphas[i] = alpha
        betas[i] = beta
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    return torch.clamp_min(torch.linalg.eigvalsh(T)[-1], 0.0).to(dtype)


def _as_matrix(M, device=None):
    """``M`` as a tensor of its own dtype: a tensor stays where it is unless
    ``device`` is given, anything else goes to ``default_device(device)``."""
    if isinstance(M, torch.Tensor):
        return M if device is None else M.to(device)
    M = np.asarray(M)
    if not M.flags.writeable:
        M = M.copy()
    return torch.as_tensor(M, device=default_device(device))


def gram_norm_sq(M, device=None):
    """``lambda_max(M^T M)`` for a small dense matrix: ``eigvalsh`` of the
    smaller of the two Gram matrices (an integer matrix is eigensolved in
    the default float dtype)."""
    M = _as_matrix(M, device)
    if not M.is_floating_point():
        M = M.to(torch.get_default_dtype())
    G = M.T @ M if M.shape[0] >= M.shape[1] else M @ M.T
    return torch.linalg.eigvalsh(G)[-1]


def _matmul(L, X):
    """``L @ X`` with JAX's dtype promotion (PyTorch's matmul refuses mixed
    dtypes); ``L`` dense or sparse, ``X`` 1-D or 2-D."""
    dtype = torch.promote_types(L.dtype, X.dtype)
    L, X = L.to(dtype), X.to(dtype)
    if L.layout == torch.strided:
        return L @ X
    # torch.sparse takes a 2-D right operand in every layout, a 1-D one in
    # only some
    if X.dim() == 1:
        return torch.sparse.mm(L, X[:, None])[:, 0]
    return torch.sparse.mm(L, X)


class LinearOperator:
    """Base linear operator. Subclasses implement ``matvec``/``rmatvec``
    and ``spectral_norm_sq`` (``= lambda_max(L^T L)``, the reference's
    ``MatrixAdapter.spectral_norm``)."""

    def matvec(self, X):
        raise NotImplementedError

    def rmatvec(self, X):
        raise NotImplementedError

    # reference-compatible aliases
    def dot(self, X):
        return self.matvec(X)

    @property
    def T(self):
        raise NotImplementedError

    @property
    def spectral_norm(self):
        # the reference's name for lambda_max(L^T L); see the module docstring
        return self.spectral_norm_sq


class IdentityOperator(LinearOperator):
    """The identity map. ``matvec`` is a no-op; the spectral norm is the
    Python number 1."""

    is_identity = True

    def matvec(self, X):
        return X

    def rmatvec(self, X):
        return X

    @property
    def T(self):
        return self

    @property
    def spectral_norm_sq(self):
        return 1.0

    def __repr__(self):
        return "IdentityOperator()"


class _MatrixBacked(LinearOperator):
    """What the dense and the sparse operator share: the two application
    modes. ``axis=None``: the ordinary product ``L @ X``. ``axis=1``: the
    reference's flattened-dot mode for per-component application,
    ``(L @ X.reshape(-1)).reshape(X.shape[0], -1)``."""

    is_identity = False

    def _apply(self, L, X):
        if self.axis is None:
            return _matmul(L, X)
        if self.axis == 1:
            return _matmul(L, X.reshape(-1)).reshape(X.shape[0], -1)
        raise NotImplementedError("axis=0 is a plain matmul; use axis=None")

    def matvec(self, X):
        return self._apply(self.L, X)

    def rmatvec(self, X):
        return self._apply(self._LT(), X)

    @property
    def spectral_norm_sq(self):
        return self._norm_sq

    @property
    def shape(self):
        return tuple(self.L.shape)


class MatrixOperator(_MatrixBacked):
    """Dense-matrix linear operator with cached ``lambda_max(L^T L)`` (a
    0-d tensor on the matrix's device)."""

    def __init__(self, L, axis=None, _norm_sq=None, device=None):
        self.L = _as_matrix(L, device)
        self.axis = axis
        if _norm_sq is None:
            _norm_sq = gram_norm_sq(self.L)
        self._norm_sq = _norm_sq

    def _LT(self):
        return self.L.T

    @property
    def T(self):
        # the transpose keeps the axis mode, like the reference;
        # lambda_max(L L^T) == lambda_max(L^T L), so the cache carries over
        return MatrixOperator(self.L.T, axis=self.axis,
                              _norm_sq=self._norm_sq)

    @property
    def ndim(self):
        return self.L.dim()

    @property
    def size(self):
        return self.L.numel()

    def __len__(self):
        return self.L.shape[0]

    def __repr__(self):
        return f"MatrixOperator(shape={self.shape}, axis={self.axis})"


class FunctionOperator(LinearOperator):
    """Matrix-free linear operator from ``matvec``/``rmatvec`` callables on
    tensors: the action of a structured operator (finite differences,
    convolutions, wavelets, ...) instead of a sparse matrix, so nothing
    larger than the operand is ever formed.

    Args:
        matvec: ``x -> L x`` for a tensor ``x`` of ``in_shape``.
        rmatvec: ``y -> L^T y``, the true adjoint of ``matvec`` (Lanczos and
            the ADMM dual updates rely on it).
        in_shape: shape of the operand ``x``.
        dtype: dtype of the Lanczos probe.
        norm_sq: a known ``lambda_max(L^T L)`` (e.g. 4 for forward
            differences along one axis); skips the Lanczos iteration, and
            then the constructor makes no tensor.
        num_iters: Lanczos steps.
        device: where the Lanczos probe runs (default: the CUDA device).
    """

    is_identity = False

    def __init__(self, matvec, rmatvec, in_shape, dtype=torch.float32,
                 norm_sq=None, num_iters=64, device=None):
        self._mv = matvec
        self._rmv = rmatvec
        self.in_shape = tuple(int(s) for s in in_shape)
        self.dtype = as_torch_dtype(dtype)
        self.num_iters = int(num_iters)
        self.device = device
        if norm_sq is None:
            # Lanczos, not power iteration: structured operators have
            # clustered top eigenvalues, where power iteration stalls at
            # about 1% error even after 64 passes
            norm_sq = lanczos_norm_sq(matvec, rmatvec, self.in_shape,
                                      num_iters=self.num_iters,
                                      dtype=self.dtype, device=device)
            self.device = norm_sq.device
        self._norm_sq = norm_sq

    def matvec(self, X):
        return self._mv(X)

    def rmatvec(self, X):
        return self._rmv(X)

    @property
    def out_shape(self):
        """The shape of ``L x``, from a storage-less ``meta`` tensor; a
        ``matvec`` that cannot run on one (it closes over real tensors)
        gets a zeros probe on the operator's device instead."""
        try:
            probe = self._mv(torch.empty(self.in_shape, dtype=self.dtype,
                                         device="meta"))
        except Exception:
            probe = self._mv(torch.zeros(self.in_shape, dtype=self.dtype,
                                         device=default_device(self.device)))
        return tuple(probe.shape)

    @property
    def T(self):
        # lambda_max(L L^T) == lambda_max(L^T L): the cached norm carries
        # over, so no Lanczos on the transpose
        return FunctionOperator(self._rmv, self._mv, self.out_shape,
                                dtype=self.dtype, norm_sq=self._norm_sq,
                                num_iters=self.num_iters, device=self.device)

    @property
    def spectral_norm_sq(self):
        return self._norm_sq

    def __repr__(self):
        return (f"FunctionOperator(in_shape={self.in_shape}, "
                f"dtype={self.dtype})")


class SparseOperator(_MatrixBacked):
    """Sparse linear operator on a coalesced ``torch.sparse`` COO tensor.

    Counterpart of the JAX package's BCOO operator: a scipy.sparse matrix
    converts through ``.tocoo()`` (indices and data on the device, O(nnz)
    memory); a ``torch.sparse`` tensor is taken as it is. The transpose is
    kept as a second coalesced tensor, made at the first ``rmatvec``. The
    cached ``lambda_max(L^T L)`` comes from :func:`lanczos_norm_sq`. For
    purely structured actions prefer :class:`FunctionOperator`.
    """

    def __init__(self, L, axis=None, _norm_sq=None, num_iters=64,
                 device=None, _transpose=None):
        if hasattr(L, "tocoo"):  # scipy.sparse
            coo = L.tocoo()
            idx = np.stack([coo.row, coo.col]).astype(np.int64)
            L = torch.sparse_coo_tensor(
                torch.as_tensor(idx), torch.as_tensor(coo.data),
                size=coo.shape, check_invariants=False,
            ).to(default_device(device))
        elif device is not None:
            L = L.to(device)
        if L.layout != torch.sparse_coo:
            L = L.to_sparse_coo()
        self.L = L.coalesce()
        self.axis = axis
        self._transpose = _transpose
        if _norm_sq is None:
            _norm_sq = lanczos_norm_sq(
                lambda v: _matmul(self.L, v),
                lambda v: _matmul(self._LT(), v),
                (self.L.shape[1],), num_iters=num_iters, dtype=self.L.dtype,
                device=self.L.device)
        self._norm_sq = _norm_sq

    def _LT(self):
        if self._transpose is None:
            self._transpose = self.L.t().coalesce()
        return self._transpose

    @property
    def T(self):
        return SparseOperator(self._LT(), axis=self.axis,
                              _norm_sq=self._norm_sq, _transpose=self.L)

    def __repr__(self):
        return (f"SparseOperator(shape={self.shape}, "
                f"nse={self.L._nnz()}, axis={self.axis})")


def _is_sparse(L):
    return hasattr(L, "toarray") or (isinstance(L, torch.Tensor)
                                     and L.layout != torch.strided)


def as_linear_operator(L, axis=None, device=None):
    """Coerce ``None`` / array / scipy.sparse / ``torch.sparse`` /
    :class:`LinearOperator` into a :class:`LinearOperator`, with the
    reference ``MatrixAdapter`` constructor's semantics, de-cascading
    included (an operator is returned unchanged). Sparse inputs stay
    sparse."""
    if L is None:
        return IdentityOperator()
    if isinstance(L, LinearOperator):
        return L
    if _is_sparse(L):
        return SparseOperator(L, axis=axis, device=device)
    return MatrixOperator(L, axis=axis, device=device)


def MatrixAdapter(L, axis=None, device=None):
    """Reference-compatible alias for :func:`as_linear_operator`."""
    return as_linear_operator(L, axis=axis, device=device)


def get_spectral_norm(L, device=None):
    """Reference-compatible: ``lambda_max(L^T L)`` for ``None``, a matrix
    or an operator."""
    if L is None:
        return 1
    if isinstance(L, LinearOperator):
        return L.spectral_norm_sq
    if hasattr(L, "spectral_norm"):
        return L.spectral_norm
    if _is_sparse(L):
        return SparseOperator(L, device=device).spectral_norm_sq
    return gram_norm_sq(L, device)
