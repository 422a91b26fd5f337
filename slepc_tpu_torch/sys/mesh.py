"""The row partition over ``torch.distributed`` (``slepc_tpu/sys/mesh.py``).

The reference drives one global array from one process: a 1-D
``jax.sharding.Mesh`` axis named ``"rows"`` partitions every vector and
basis by rows, and GSPMD inserts the psum / all-gather /
collective-permute that SLEPc issues as MPI_Allreduce / VecScatter.  The
port uses PyTorch's idiom instead: one process (a *rank*) per card under
``torch.distributed``, each rank holding its own contiguous range of rows,
and every collective written out.

  * :class:`RowMesh` is the process group, this rank, the world size and
    the rank's device, with counters of every collective it runs (calls
    and bytes of all-reduce, all-gather and halo exchange, and the
    seconds spent staging halo rows through host memory).
  * The backend is NCCL on CUDA cards, one rank a card, and gloo on the
    CPU (the CPU tests run 2 and 4 ranks this way).  Gloo can also run
    ranks that share one card; its collectives then stage the card's
    tensors through host memory, counted and timed.
  * Every rank runs the same host code on the same reduced numbers (the
    projected eigh, the restart choice, the Chebyshev window), so the ranks
    stay in lockstep.  A decision taken on rank-local data would leave the
    other ranks waiting in a collective; every such decision reads a
    reduced value.
  * :func:`allreduce` is the one helper that every reduction over local
    rows goes through.  Inside :func:`reducing` over a partitioned operator
    it sums over the ranks; anywhere else it is the identity (no launch, no
    synchronization), so the single-card path is unchanged.

The reference's ``row_sharding``, ``replicated_sharding``,
``device_put_rows`` and ``device_put_basis_t`` have no counterpart: on a
rank a tensor *is* its shard.  :meth:`RowMesh.row_range` says which rows a
rank holds, a partitioned operator's ``local_rows`` cuts a global block to
them, and :meth:`RowMesh.gather_rows` assembles the ranks' rows again.
:func:`shard_operator` is the counterpart of the GSPMD default: vectors
stay whole on every rank, each rank computes its rows of y on the
operator's own kernel, and one all-gather assembles y.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import datetime
import functools
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

ROWS = "rows"

_mesh: Optional["RowMesh"] = None
# the partitioned operator whose slab rows the running solve holds
_reducing: contextvars.ContextVar = contextvars.ContextVar(
    "slepc_tpu_torch_reducing", default=None)

_COUNTERS = ("allreduce", "allreduce_bytes", "allgather", "allgather_bytes",
             "halo", "halo_bytes", "halo_stage_s")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RowMesh:
    """A 1-D row partition over a ``torch.distributed`` process group.

    ``group`` None is the default group; ``device`` None is the card of
    this rank (``cuda:LOCAL_RANK`` under NCCL, the current card under
    gloo) and raises without one, as ``sys/device.py`` does: the CPU must
    be asked for (``device="cpu"``)."""

    def __init__(self, group=None, device=None):
        if not dist.is_initialized():
            raise RuntimeError("RowMesh needs torch.distributed: call "
                               "init_distributed() (or init_process_group) "
                               "first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'RowMesh runs on a CUDA card by default and found none; '
                    'pass device="cpu" for gloo ranks on the CPU')
            local = int(os.environ.get("LOCAL_RANK", 0)) \
                if self.backend == "nccl" else torch.cuda.current_device()
            device = torch.device("cuda", local)
        self.device = torch.device(device)
        # gloo moves host memory: a card's tensors go through the host
        self._stage = self.backend == "gloo" and self.device.type == "cuda"
        self._bufs = {}
        self.reset_counters()

    def __repr__(self):
        return (f"RowMesh(rank={self.rank}, world={self.world}, "
                f"backend={self.backend}, device={self.device})")

    # ---- rows ------------------------------------------------------------
    def row_range(self, n: int, rank: Optional[int] = None):
        """The contiguous rows [lo, hi) of ``rank`` (default: this one) in
        an n-row partition: the first n % world ranks hold one row more."""
        r = self.rank if rank is None else rank
        base, rem = divmod(int(n), self.world)
        lo = r * base + min(r, rem)
        return lo, lo + base + (1 if r < rem else 0)

    # ---- counters ----------------------------------------------------------
    def reset_counters(self) -> None:
        self.counters = dict.fromkeys(_COUNTERS, 0)
        self.counters["halo_stage_s"] = 0.0

    def _count(self, what: str, t: torch.Tensor) -> None:
        self.counters[what] += 1
        self.counters[what + "_bytes"] += _nbytes(t)

    # ---- collectives -------------------------------------------------------
    def allreduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the ranks in place and return it (``op`` sum,
        max or min; a complex tensor sums its real view).  A strided ``t``
        is reduced in a contiguous copy, which is written back."""
        self._count("allreduce", t)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        src = torch.view_as_real(t) if t.is_complex() else t
        buf = src.to("cpu", memory_format=torch.contiguous_format) \
            if self._stage else src.contiguous()
        dist.all_reduce(buf, red, group=self.group)
        if buf is not src:
            src.copy_(buf)
        return t

    def allgather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equally shaped tensors stacked, (world,) + t.shape."""
        self._count("allgather", t)
        src = torch.view_as_real(t) if t.is_complex() else t
        src = src.contiguous()
        if self._stage:
            src = src.cpu()
        out = torch.empty((self.world,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.group) \
            if self.backend == "nccl" else \
            dist.all_gather(list(out.unbind(0)), src, group=self.group)
        out = out.to(t.device)
        return torch.view_as_complex(out) if t.is_complex() else out

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The ranks' rows of an n-row partition joined along the last axis,
        on every rank (rank 0 included): x is (..., hi - lo), the result
        (..., n).  One all-gather, the rows padded to the largest range."""
        width = self.row_range(n, 0)[1]
        lo, hi = self.row_range(n)
        pad = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype,
                          device=x.device)
        pad[..., : hi - lo] = x
        parts = self.allgather(pad)
        return torch.cat([parts[r][..., : b - a] for r, (a, b) in enumerate(
            self.row_range(n, r) for r in range(self.world))], dim=-1)

    def halo_exchange(self, X: torch.Tensor, h: int, nloc: int) -> None:
        """Fill the halos of the slab rows X (..., h + nloc + h): the last h
        interior rows of the left neighbour into X[..., :h], the first h of
        the right one into X[..., h + nloc:], in one exchange for every row
        of a block.  The first and last ranks' outer halos stay zero."""
        self.counters["halo"] += 1
        if h == 0 or self.world == 1:
            return
        if X.is_complex():  # (re, im) pairs: the rows are dim -2
            X = torch.view_as_real(X)
            cut = lambda a, b: X[..., a:b, :]
        else:
            cut = lambda a, b: X[..., a:b]
        left, right = self.rank - 1, self.rank + 1
        peers = [p for p in (left, right) if 0 <= p < self.world]
        sends = {left: cut(h, 2 * h), right: cut(nloc, nloc + h)}
        recvs = {left: cut(0, h), right: cut(h + nloc, 2 * h + nloc)}
        t0 = time.perf_counter()
        bufs = {}
        for p in peers:
            s, r = sends[p], recvs[p]
            self.counters["halo_bytes"] += _nbytes(s)
            if self._stage or not s.is_contiguous():
                sb, rb = self._buffers(p, s)
                sb.copy_(s)
                bufs[p] = rb
            else:
                sb, rb = s, r
            sends[p], recvs[p] = sb, rb
        if self._stage:
            torch.cuda.current_stream(X.device).synchronize()
            self.counters["halo_stage_s"] += time.perf_counter() - t0
        ops = []
        for p in peers:  # P2POp takes a global rank
            g = p if self.group is None else \
                dist.get_global_rank(self.group, p)
            ops.append(dist.P2POp(dist.isend, sends[p], g, group=self.group))
            ops.append(dist.P2POp(dist.irecv, recvs[p], g, group=self.group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        t1 = time.perf_counter()
        for p, rb in bufs.items():
            (cut(0, h) if p == left else cut(h + nloc, 2 * h + nloc)).copy_(rb)
        if self._stage:
            self.counters["halo_stage_s"] += time.perf_counter() - t1

    def _buffers(self, peer: int, like: torch.Tensor):
        """A send and a receive buffer for ``peer``, kept between calls:
        pinned host memory when gloo stages a card's rows, else contiguous
        ones on the rows' device."""
        key = (peer, tuple(like.shape), like.dtype)
        if key not in self._bufs:
            if self._stage:
                mk = lambda: torch.empty(like.shape, dtype=like.dtype,
                                         pin_memory=True)
            else:
                mk = lambda: torch.empty(like.shape, dtype=like.dtype,
                                         device=like.device)
            self._bufs[key] = (mk(), mk())
        return self._bufs[key]


def set_mesh(mesh: Optional[RowMesh]) -> None:
    """Install the global row mesh (None: one process, no partition).  With
    a mesh set, the Hermitian fast path routes a DIA operator, and a CSR
    operator of at least 4,096 rows, to its partitioned form."""
    global _mesh
    _mesh = mesh


def get_mesh() -> Optional[RowMesh]:
    return _mesh


def make_row_mesh(group=None, device=None) -> RowMesh:
    """The row mesh over ``group`` (default: every rank)."""
    return RowMesh(group, device)


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> bool:
    """Start ``torch.distributed`` from the arguments or from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  Without
    either it does nothing (a one-process run).  The backend defaults to
    NCCL when a card is present and gloo otherwise.  Returns True when more
    than one rank is live (reference ``init_distributed``, mesh.py:45-78)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and not from_env:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


# ---- the reductions of a partitioned solve ---------------------------------

@contextlib.contextmanager
def reducing(op):
    """Inside, :func:`allreduce` sums over the ranks of ``op.mesh`` (a
    partitioned operator's); an operator without a mesh leaves the current
    setting as it is, so a wrapper (a Chebyshev filter over a partitioned
    operator) runs inside its base's reductions."""
    if getattr(op, "mesh", None) is None:
        yield
        return
    token = _reducing.set(op)
    try:
        yield
    finally:
        _reducing.reset(token)


def reduces_over_op(fn):
    """``fn(op, ...)`` run inside :func:`reducing` over its operator."""
    @functools.wraps(fn)
    def run(op, *args, **kwargs):
        with reducing(op):
            return fn(op, *args, **kwargs)
    return run


def reducing_mesh() -> Optional[RowMesh]:
    """The mesh the running solve reduces over, or None."""
    op = _reducing.get()
    return None if op is None else op.mesh


def allreduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks of the running partitioned solve (in
    place), or ``t`` itself outside one."""
    mesh = reducing_mesh()
    return t if mesh is None else mesh.allreduce(t, op)


def clear_halos(X: torch.Tensor) -> torch.Tensor:
    """X with the running partitioned solve's halo entries zeroed (a random
    row drawn on the slab must keep the slab's zeros at rest); X itself
    outside one."""
    op = _reducing.get()
    return X if op is None else op.zero_halos(X)


def combine_norms(nrm: torch.Tensor) -> torch.Tensor:
    """Global 2-norms from the ranks' local ones (sqrt of the summed
    squares); the local norms themselves outside a partitioned solve."""
    if _reducing.get() is None:
        return nrm
    return allreduce(nrm * nrm).sqrt_()


def vector_norm(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``torch.linalg.vector_norm`` over the rows of every rank."""
    return combine_norms(torch.linalg.vector_norm(x, dim=dim))


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on one (a decision taken on
    rank-local data, such as a clock or free memory, made common)."""
    mesh = reducing_mesh()
    if mesh is None:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    return bool(mesh.allreduce(t, "max")[0] > 0)


# ---- the GSPMD default: whole vectors, rows computed by rank ---------------

class _RowShard:
    """The rows [lo, hi) of an operator on one rank: ``local(x)`` gives
    y[lo:hi] from the whole x on the operator's own kernel, one all-gather
    the whole y."""

    def __init__(self, mesh: RowMesh, m: int, local):
        self.mesh, self.m, self.local = mesh, m, local

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self.local(x)
        parts = self.mesh.allgather(y)          # (world, ..., m/world)
        return torch.cat(parts.unbind(0), dim=-1)


def _dia_rows(op, mesh: RowMesh, block: bool):
    from ..mat.linop import DIAOperator

    n = op.shape[0]
    lo, hi = mesh.row_range(n)
    h = max((abs(o) for o in op.offsets), default=0)
    s, e = max(lo - h, 0), min(hi + h, n)
    d = torch.zeros((len(op.offsets), e - s), dtype=op.dtype,
                    device=op.device)
    d[:, lo - s: hi - s] = op.diags[:, lo:hi]
    part = DIAOperator(op.offsets, d)
    fn = part.mult_block if block else part.mult
    return lambda x: fn(x[..., s:e].contiguous())[..., lo - s: hi - s]


def _csr_rows(op, mesh: RowMesh):
    from ..mat.linop import AIJOperator

    lo, hi = mesh.row_range(op.shape[0])
    a, b = int(op.rowptr[lo]), int(op.rowptr[hi])
    part = AIJOperator(op.rowptr[lo: hi + 1] - a, op.cols[a:b], op.vals[a:b],
                       (hi - lo, op.shape[1]))
    return part.mult


def _dense_rows(op, mesh: RowMesh, adjoint: bool):
    from ..mat.linop import apply_by_parts

    lo, hi = mesh.row_range(op.shape[1] if adjoint else op.shape[0])
    part = op.A[:, lo:hi].mH if adjoint else op.A[lo:hi]
    return lambda x: apply_by_parts(lambda v: part @ v, x, op.dtype)


def shard_operator(op, mesh: Optional[RowMesh] = None):
    """A copy of ``op`` whose products are partitioned by rows over the
    mesh (reference ``shard_operator``, mesh.py:100-160): vectors stay
    whole on every rank; each rank computes its rows of y on the operator's
    own kernel (K1/K2/K5 for DIA, K6 for CSR, the adjoint CSR of a
    rectangular matrix too; a dense matrix's rows) and one all-gather
    assembles y.  A dimension that does not divide by the world size stays
    replicated, as in the reference.  The copy's ``shard_form``
    (``shard_form_h`` for the adjoint) records what ``mult`` runs: "rows"
    or "replicated"; its ``own_rows`` are this rank's rows, so the fast
    path returns eigenvectors as each rank's rows, as on the halo path.
    ``op`` itself is left as it was (it shares its tensors with the copy),
    so it never issues a collective; without a mesh ``op`` is returned."""
    from ..mat.linop import AIJOperator, DenseOperator, DIAOperator

    mesh = mesh if mesh is not None else _mesh
    if mesh is None:
        return op
    out = copy.copy(op)
    m, n = op.shape
    # a solve's eigenvectors are each rank's own rows, as on the halo path
    out.own_rows = mesh.row_range(m)
    rows_ok = m % mesh.world == 0
    if isinstance(op, DIAOperator) and rows_ok and m == n:
        out.row_shard = _RowShard(mesh, m, _dia_rows(op, mesh, False))
        out.row_shard_block = _RowShard(mesh, m, _dia_rows(op, mesh, True))
    elif isinstance(op, (AIJOperator, DenseOperator)):
        dense = isinstance(op, DenseOperator)
        if rows_ok:
            out.row_shard = _RowShard(mesh, m, _dense_rows(op, mesh, False)
                                      if dense else _csr_rows(op, mesh))
        out.shard_form_h = "replicated"
        if n % mesh.world == 0:
            if dense:
                out.row_shard_h = _RowShard(mesh, n,
                                            _dense_rows(op, mesh, True))
            else:
                adj = copy.copy(op.adjoint())
                adj.row_shard = _RowShard(mesh, n, _csr_rows(adj, mesh))
                out._adjoint = adj
            out.shard_form_h = "rows"
        if not dense:  # the routed form is chosen again, for the copy
            out._fast = None
    out.shard_form = "rows" if getattr(out, "row_shard", None) is not None \
        else "replicated"
    return out


def nrows_padded(n: int, mesh: Optional[RowMesh] = None) -> int:
    """n rounded up to a multiple of the world size (the size at which
    :func:`shard_operator` partitions rather than replicates)."""
    mesh = mesh if mesh is not None else _mesh
    if mesh is None:
        return n
    k = mesh.world
    return ((n + k - 1) // k) * k
