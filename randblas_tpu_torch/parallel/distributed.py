"""Distributed sketching over torch.distributed (counterpart of
randblas_tpu/parallel/distributed.py).

Layout of B = S @ A (left sketch) on a ('model', 'data') DeviceMesh:

    A: placements [Replicate(), Shard(0)]  -- m (long) axis over 'data'
    S: implicit    -- each rank generates its (d/model x m/data) tile of
                      the global operator from (seed, tile offsets)
    B: placements [Shard(0), Replicate()]  -- d axis over 'model';
                      the contraction over m is all-reduced over 'data'

Each rank's shard body is a plain function of (mesh coordinates, mesh
shape, local blocks, operator) that returns the rank's partial product
(``left_shard``, ``right_shard``, ``cols_shard``, ``sparse_shard``,
``sparse_data_shard``). The entry points take this rank's blocks, run its
body and add the partials with one all-reduce over 'data' (the JAX
package's psum). A shard's tile is bit for bit the slice of the
single-device operator: its offsets fold into the base counter with the
TRUE parent's stride (K1 and the fill kernel K3 do this), so only the
contraction's sum is reassociated across 'data'.

Tensors at the boundary: an input may be a DTensor on the mesh or a plain
tensor, which is taken as replicated (each rank takes its own block, as
shard_map does with an unsharded input); a DTensor whose shards are laid
out otherwise is gathered first. Outputs are DTensors; shards follow
DTensor's chunking (ceil(extent / parts) rows a rank, the last ones
shorter or empty). The contraction axis of a dense operator is cut as the
JAX package cuts it: extents rounded up to the counter width, so shard
offsets land on counter boundaries (``_shard_extent``); a shard past the
true parent is clipped, never generated.

Routes of a shard: a lazy Gaussian or Uniform operator with a 4x32
generator takes the fused kernel K1 on CUDA tensors where ``skge``'s K1
gate (``fused_profitable``) takes the shard's kernel call
(``use_fused="auto"``), so a 1 x 1 mesh routes as the single-device call
does; K1's plain version on CPU tensors under ``use_fused=True``; and the
staged fill (K3 on the card) and ``torch.matmul`` under
``use_fused=False``, where the gate declines or where K1 does not take the
tile. A canonical wide SASO shard takes K4 where
``skge``'s K4 gate does. The sketches are differentiable in A: the
all-reduce over 'data' passes the cotangent through unchanged, the shard
body differentiates as it does on one device (K1's backward pass is K2),
and a block replicated over 'model' sums its replicas' cotangents with an
all-reduce over 'model'.

Not ported: the JAX package's compiled-program cache (``_FN_CACHE``) and
shard_map's ``check_vma`` (eager PyTorch compiles nothing), and
``_pack_seed_words`` (K1 folds the tile's offsets into its base counter).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import profiling
from ..base import Layout, MajorAxis, require
from ..dense import DenseDist, DenseDistName, DenseSkOp, dist_to_layout
from ..sparse import SparseSkOp
from ..trig import TrigSkOp, _signed_padded

MESH_DIMS = ("model", "data")


def make_sketch_mesh(model: int = 1, data: Optional[int] = None,
                     devices=None, *, device_type: str = "cuda") -> DeviceMesh:
    """A ('model', 'data') DeviceMesh over ``devices`` (ranks of the default
    process group, all of them by default), row-major: rank ``devices[i *
    data + j]`` sits at (i, j). Call after the process group is up
    (``initialize_multihost``); every rank calls it with the same
    arguments. Tests on the CPU pass ``device_type="cpu"`` (gloo)."""
    require(dist.is_available() and dist.is_initialized(),
            "make_sketch_mesh needs an initialized default process group "
            "(initialize_multihost or torch.distributed.init_process_group)")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    if data is None:
        data = len(ranks) // model
    require(model * data == len(ranks),
            f"mesh {model}x{data} != {len(ranks)} devices")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(model, data),
                      mesh_dim_names=MESH_DIMS)


def _shard_extent(total: int, parts: int, align: int = 1) -> int:
    """Per-shard extent covering ``total`` over ``parts`` shards, rounded
    up to ``align`` (the pad-and-shard scheme of the JAX package: aligned
    shard offsets along the counter axis)."""
    per = -(-total // parts)
    return -(-per // align) * align


def shard_span(total: int, per: int, index: int):
    """(offset, extent) of shard ``index`` of extent ``per`` along an axis
    of ``total``: the last shards are clipped to the true extent, and may
    be empty."""
    off = index * per
    return off, max(0, min(per, total - off))


def _mesh(mesh: DeviceMesh):
    """((model, data) shape, this rank's (model, data) coordinate)."""
    require(tuple(mesh.mesh_dim_names or ()) == MESH_DIMS,
            "the mesh must have the dimensions ('model', 'data') "
            "(make_sketch_mesh)")
    coord = mesh.get_coordinate()
    require(coord is not None, "this rank is not in the mesh")
    return (mesh.size(0), mesh.size(1)), tuple(coord)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in place; None: t itself (the
    in-process emulation of one shard, whose partials are added by the
    caller)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _SumOver(torch.autograd.Function):
    """Forward: the partials summed over a group (an all-reduce; the JAX
    package's psum). Backward: the cotangent unchanged, since each partial's
    cotangent is the sum's."""

    @staticmethod
    def forward(ctx, part, group):
        return _all_reduce(part.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Forward: a block replicated over a group, as it is. Backward: its
    replicas' cotangents summed over the group (an all-reduce): each
    replica sees another tile of the operator."""

    @staticmethod
    def forward(ctx, a, group):
        ctx.group = group
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _Take(torch.autograd.Function):
    """Forward: this rank's block of a tensor replicated on every rank.
    Backward: the blocks' cotangents put in place and summed over the
    group that holds the other blocks, so each rank holds the full
    gradient of its replica."""

    @staticmethod
    def forward(ctx, a, dim, off, ext, group):
        ctx.meta = (a.shape, dim, off, ext, group)
        return a.narrow(dim, off, ext).clone()

    @staticmethod
    def backward(ctx, g):
        shape, dim, off, ext, group = ctx.meta
        full = g.new_zeros(shape)
        full.narrow(dim, off, ext).copy_(g)
        return _all_reduce(full, group), None, None, None, None


def sum_over(part: torch.Tensor, group) -> torch.Tensor:
    """``part`` summed over ``group``, differentiable (``_SumOver``);
    recorded as the span ``sum_over`` (the all-reduce's enqueue)."""
    with profiling.span("sum_over"):
        if torch.is_grad_enabled() and part.requires_grad:
            return _SumOver.apply(part, group)
        return _all_reduce(part.contiguous(), group)


def replicated(a: torch.Tensor, group) -> torch.Tensor:
    """``a``, whose cotangents are summed over ``group`` (``_Replicated``)."""
    if torch.is_grad_enabled() and a.requires_grad:
        return _Replicated.apply(a, group)
    return a


def local_block(a, mesh: DeviceMesh, dim: int, per: int, index: int,
                axis: int = 1) -> torch.Tensor:
    """This rank's block of ``a`` along ``dim``: shard ``index`` of extent
    ``per`` (clipped), the mesh's dimension ``axis`` cutting that tensor
    dimension. A DTensor sharded so already gives its local tensor; any
    other DTensor is gathered first, and a plain tensor is taken as
    replicated."""
    total = a.shape[dim]
    off, ext = shard_span(total, per, index)
    if isinstance(a, DTensor):
        require(a.device_mesh == mesh, "the DTensor lies on another mesh")
        want = [Replicate(), Replicate()]
        want[axis] = Shard(dim)
        chunk = -(-total // mesh.size(axis))
        if list(a.placements) == want and (mesh.size(axis) == 1
                                           or chunk == per):
            return a.to_local()
        a = a.full_tensor()
    group = mesh.get_group(MESH_DIMS[axis])
    if torch.is_grad_enabled() and a.requires_grad:
        return _Take.apply(a, dim, off, ext, group)
    return a.narrow(dim, off, ext)


def as_dtensor(local: torch.Tensor, mesh: DeviceMesh, placements,
               shape) -> DTensor:
    """The global tensor of ``shape`` whose shards are the ranks' ``local``
    blocks, laid out as DTensor chunks them."""
    shape = torch.Size(shape)
    stride, acc = [], 1
    for size in reversed(shape):
        stride.insert(0, acc)
        acc *= size
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def _require_x32(S: DenseSkOp) -> None:
    """The JAX package's shard fill generates 4x32/2x32 streams only: an
    x64 seed raises there, and so it does here."""
    require(not S.seed_state.is_x64,
            f"{S.seed_state.rng} has no shard fill on a mesh: the x64 "
            "CBRNGs are host-side; sketch with a 32-bit generator")


def _fused_ok(S: DenseSkOp, dist_rowmajor: DenseDist, a: torch.Tensor,
              use_fused, rows: int, contraction: int) -> bool:
    """Whether a shard takes K1 for the RowMajor-natural ``dist_rowmajor``
    on the kernel call of a (rows, contraction) tile times ``a``
    (contraction, n): skge's gates (a lazy Gaussian or Uniform operator, a
    4x32 generator, float32 or bf16 data, the JAX package's float32
    operator; under "auto" a CUDA tensor and ``skge.fused_profitable``,
    anywhere under True)."""
    from ..ops.fused_sketch import SUPPORTED_RNGS
    ok = (use_fused is not False and S.materialized is None
          and S.dtype == torch.float32
          and S.seed_state.rng in SUPPORTED_RNGS
          and dist_rowmajor.family in (DenseDistName.Gaussian,
                                       DenseDistName.Uniform)
          and dist_to_layout(dist_rowmajor) == Layout.RowMajor
          and a.dtype in (torch.float32, torch.bfloat16))
    if use_fused is True:
        require(ok, "fused distributed path forced but unsupported")
        return True
    from .. import base, skge
    return (ok and base.on_card(a)
            and skge.fused_profitable(rows, contraction, a.shape[1], a.dtype))


def _scaled(alpha, t: torch.Tensor) -> torch.Tensor:
    if alpha == 1:
        return t
    return torch.as_tensor(alpha, dtype=t.dtype) * t


def _transposed(S: DenseSkOp) -> DenseSkOp:
    """The lazy operator of the transposed distribution, same seed."""
    d = S.dist
    return DenseSkOp(DenseDist(d.n_cols, d.n_rows, d.family, d.major_axis),
                     S.seed_state, dtype=S.dtype)


def _tile_times(S: DenseSkOp, a: torch.Tensor, rows: int, cols: int,
                ro: int, co: int, alpha, fused: bool) -> torch.Tensor:
    """alpha * S[ro:ro+rows, co:co+cols] @ a: K1 (``fused``), or the tile
    filled (K3 on the card) and ``torch.matmul`` in the operator's
    dtype."""
    from ..ops.fused_sketch import fused_sketch
    if rows == 0 or cols == 0:  # K1's output dtype: bf16 for bf16 data
        out = (a.dtype if a.dtype == torch.bfloat16 else torch.float32) \
            if fused else S.dtype
        return a.new_zeros((rows, a.shape[1]), dtype=out)
    if fused:
        return fused_sketch(S, a, alpha=float(alpha), rows_s=rows,
                            cols_s=cols, ro_s=ro, co_s=co)
    blk = S.submat(rows, cols, ro, co, device=a.device)
    return _scaled(alpha, torch.matmul(blk, a.to(S.dtype)))


# ------------------------------------------------------------ the layouts


def left_extents(S, shape):
    """(d_per, m_per) of the left layout: the output rows in DTensor
    chunks over 'model', the contraction at the counter width over
    'data'."""
    d, m = S.shape
    return _shard_extent(d, shape[0]), _shard_extent(m, shape[1],
                                                     S.seed_state.len_c)


def left_shard(S: DenseSkOp, a_blk: torch.Tensor, coord, shape, *,
               alpha=1.0, use_fused="auto") -> torch.Tensor:
    """The partial product of mesh position ``coord`` = (mi, di) on a mesh
    of ``shape`` for B = alpha * S @ A: alpha * S[ro:ro+rows, co:co+cols] @
    a_blk, with a_blk = A[co:co+cols] this rank's rows of A."""
    (mi, di), (d, m) = coord, S.shape
    d_per, m_per = left_extents(S, shape)
    ro, rows = shard_span(d, d_per, mi)
    co, cols = shard_span(m, m_per, di)
    require(a_blk.shape[0] == cols, f"shard {coord} takes {cols} rows of A")
    return _tile_times(S, a_blk, rows, cols, ro, co, alpha,
                       _fused_ok(S, S.dist, a_blk, use_fused, rows, cols))


def distributed_sketch(S: DenseSkOp, A, mesh: DeviceMesh, *, alpha=1.0,
                       use_fused="auto") -> DTensor:
    """B = alpha * S @ A with A m-sharded over 'data' and B d-sharded over
    'model': a DTensor with placements [Shard(0), Replicate()].

    Any (d, m, mesh) runs (pad-and-shard), and each rank's tile is the
    single-device operator's, bit for bit; partials add over 'data'. On
    CUDA tensors each tile goes through K1 where it qualifies
    (``use_fused="auto"``); True forces K1 (its plain version on the CPU),
    False the staged fill and matmul. Differentiable in A. Recorded as
    the span ``distributed_sketch``, the all-reduce inside it as
    ``sum_over``."""
    with profiling.span("distributed_sketch"):
        require(isinstance(S, DenseSkOp),
                "distributed_sketch takes a DenseSkOp")
        _require_x32(S)
        d, m = S.shape
        require(A.shape[0] == m, "A row count must equal S.n_cols")
        shape, coord = _mesh(mesh)
        m_per = left_extents(S, shape)[1]
        a_blk = local_block(A, mesh, 0, m_per, coord[1])
        a_blk = replicated(a_blk, mesh.get_group("model"))
        part = left_shard(S, a_blk, coord, shape, alpha=alpha,
                          use_fused=use_fused)
        out = sum_over(part, mesh.get_group("data"))
        return as_dtensor(out, mesh, [Shard(0), Replicate()],
                          (d, A.shape[1]))


def distributed_sketch_jit(S: DenseSkOp, A, mesh: DeviceMesh, *,
                           alpha=1.0) -> DTensor:
    """``distributed_sketch`` (the JAX package's jit-wrapped entry; eager
    PyTorch has nothing to compile)."""
    return distributed_sketch(S, A, mesh, alpha=alpha)


def right_extents(S, shape):
    """(d_per, m_per) of the right layout: the output columns in DTensor
    chunks over 'model', the contraction at the counter width over
    'data'."""
    m, d = S.shape
    return _shard_extent(d, shape[0]), _shard_extent(m, shape[1],
                                                     S.seed_state.len_c)


def right_shard(S: DenseSkOp, a_blk: torch.Tensor, coord, shape, *,
                alpha=1.0, use_fused="auto") -> torch.Tensor:
    """The partial of mesh position ``coord`` for B = alpha * A @ S, S (m,
    d): alpha * a_blk @ S[ro:ro+rows, co:co+cols] with the tile's rows on
    'data' (a_blk = A[:, ro:ro+rows]) and its columns on 'model'. K1 takes
    the transposed product, part^T = S_t[co:, ro:] @ a_blk^T, whose tile is
    the transposed distribution's (a square one transposes to itself, so it
    stays staged)."""
    (mi, di), (m, d) = coord, S.shape
    d_per, m_per = right_extents(S, shape)
    ro, rows = shard_span(m, m_per, di)
    co, cols = shard_span(d, d_per, mi)
    require(a_blk.shape[1] == rows, f"shard {coord} takes {rows} columns "
                                    "of A")
    if (S.materialized is None and m != d
            and _fused_ok(S, _transposed(S).dist, a_blk.T, use_fused, cols,
                          rows)):
        return _tile_times(_transposed(S), a_blk.T, cols, rows, co, ro,
                           alpha, True).T
    require(use_fused is not True,
            "fused distributed path forced but unsupported")
    if rows == 0 or cols == 0:
        return a_blk.new_zeros((a_blk.shape[0], cols), dtype=S.dtype)
    blk = S.submat(rows, cols, ro, co, device=a_blk.device)
    return _scaled(alpha, torch.matmul(a_blk.to(S.dtype), blk))


def distributed_sketch_right(S: DenseSkOp, A, mesh: DeviceMesh, *,
                             alpha=1.0, use_fused="auto") -> DTensor:
    """B = alpha * A @ S with A (rows, m) column-sharded over 'data' and B
    (rows, d) d-sharded over 'model': placements [Shard(1), Replicate()].
    Each rank generates its (m/data x d/model) tile; partials add over
    'data'. Routes as for ``distributed_sketch`` (K1 on the transposed
    tile). Differentiable in A."""
    require(isinstance(S, DenseSkOp), "takes a DenseSkOp")
    _require_x32(S)
    m, d = S.shape
    require(A.shape[1] == m, "A column count must equal S.n_rows")
    shape, coord = _mesh(mesh)
    m_per = right_extents(S, shape)[1]
    a_blk = local_block(A, mesh, 1, m_per, coord[1])
    a_blk = replicated(a_blk, mesh.get_group("model"))
    part = right_shard(S, a_blk, coord, shape, alpha=alpha,
                       use_fused=use_fused)
    out = sum_over(part, mesh.get_group("data"))
    return as_dtensor(out, mesh, [Shard(1), Replicate()], (A.shape[0], d))


def sparse_extents(S, shape):
    """(d_per, m_per) of a sparse operator: DTensor chunks on both axes
    (the triplets are explicit, so no counter alignment)."""
    d, m = S.shape
    return _shard_extent(d, shape[0]), _shard_extent(m, shape[1])


def _entries_in(rows, cols, vals, r0: int, nr: int, c0: int, nc: int):
    """The COO entries inside the (nr, nc) window at (r0, c0), compacted
    (one host synchronisation for their count), so that a shard's gathers
    walk its own entries, not every entry masked."""
    keep = ((rows >= r0) & (rows < r0 + nr) & (cols >= c0)
            & (cols < c0 + nc)).nonzero().squeeze(1)
    return rows[keep], cols[keep], vals[keep]


def _canonical_wide(s: SparseSkOp) -> bool:
    return (s.canonical and s.dist.major_axis == MajorAxis.Short
            and s.n_rows < s.n_cols)


def sparse_shard(s: SparseSkOp, a_blk: torch.Tensor, coord, shape, *,
                 alpha=1.0) -> torch.Tensor:
    """The partial of mesh position ``coord`` for B = alpha * S @ A by a
    filled sparse-sign operator ``s``: output rows [ro, ro+rows) from A's
    rows a_blk = A[co:co+cols].

    A canonical wide SASO's triplets for the shard's data rows are a
    contiguous (cols, k) slice: entries outside the row window get index
    -1 (their signs stay beside them) and go through K4 where skge's K4
    gate takes (d_per, m_per, k, n), else through one ``index_add_`` per
    slot with their weights zeroed. Other operators go through
    ``coo_left_apply`` with the entries of the (ro, co) window."""
    from ..ops.coo_apply import coo_left_apply, fixed_nnz_left_apply
    from ..ops.saso_sketch import saso_sketch
    from ..skge import _saso_kernel_ok
    (mi, di), (d, m) = coord, s.shape
    d_per, m_per = sparse_extents(s, shape)
    ro, rows = shard_span(d, d_per, mi)
    co, cols = shard_span(m, m_per, di)
    require(a_blk.shape[0] == cols, f"shard {coord} takes {cols} rows of A")
    if rows == 0 or cols == 0:
        return a_blk.new_zeros((rows, a_blk.shape[1]))
    if not _canonical_wide(s):
        r, c, v = _entries_in(s.rows, s.cols, s.vals, ro, rows, co, cols)
        return coo_left_apply(r, c, v.to(a_blk.dtype), a_blk, rows, cols, ro,
                              co, alpha)
    k = s.dist.vec_nnz
    idx = s.rows.reshape(m, k)[co:co + cols].long() - ro
    sgn = s.vals.reshape(m, k)[co:co + cols]
    inside = (idx >= 0) & (idx < rows)
    if _saso_kernel_ok(d_per, m_per, k, a_blk):
        return saso_sketch(torch.where(inside, idx, -1).to(torch.int32), sgn,
                           a_blk, rows, alpha)
    w = torch.where(inside, sgn, torch.zeros((), dtype=sgn.dtype,
                                             device=sgn.device))
    return fixed_nnz_left_apply(torch.where(inside, idx, 0), w, a_blk, rows,
                                alpha)


def distributed_sparse_sketch(S: SparseSkOp, A, mesh: DeviceMesh, *,
                              alpha=1.0) -> DTensor:
    """B = alpha * S @ A for a sparse-sign operator, A m-sharded over
    'data', B d-sharded over 'model' (placements [Shard(0), Replicate()]).
    The operator is filled on A's device (every rank fills the same
    triplets); each rank applies its window of them (``sparse_shard``)
    and partials add over 'data'."""
    require(isinstance(S, SparseSkOp), "takes a SparseSkOp")
    d, m = S.shape
    require(A.shape[0] == m, "A row count must equal S.n_cols")
    shape, coord = _mesh(mesh)
    m_per = sparse_extents(S, shape)[1]
    a_blk = local_block(A, mesh, 0, m_per, coord[1])
    a_blk = replicated(a_blk, mesh.get_group("model"))
    part = sparse_shard(S.filled(a_blk.device), a_blk, coord, shape,
                        alpha=alpha)
    out = sum_over(part, mesh.get_group("data"))
    return as_dtensor(out, mesh, [Shard(0), Replicate()], (d, A.shape[1]))


def cols_extents(S, n: int, shape):
    """(d_per, n_per) of the column layout: DTensor chunks on both."""
    return _shard_extent(S.shape[0], shape[0]), _shard_extent(n, shape[1])


def cols_shard(S, a_blk: torch.Tensor, coord, shape, n: int, *, alpha=1.0,
               use_fused="auto") -> torch.Tensor:
    """The output block of mesh position ``coord`` for B = alpha * S @ A
    with A's n columns over 'data' (a_blk = A[:, c0:c0+cols], n the full
    width): alpha * S[ro:ro+rows, :] @ a_blk, no collective. A TrigSkOp
    (SRHT) transforms its own columns and keeps its 'model' slice of the
    sampled rows."""
    from ..ops.hadamard import hadamard_transform
    mi = coord[0]
    d, m = S.shape
    d_per, _ = cols_extents(S, n, shape)
    ro, rows = shard_span(d, d_per, mi)
    if isinstance(S, TrigSkOp):
        require(use_fused is not True,
                "SRHT has no fused RNG-in-GEMM kernel (the transform IS "
                "the apply); use_fused=True cannot be honored for a "
                "TrigSkOp")
        signs, indices = S._sample(a_blk.device)
        x = _signed_padded(signs.to(a_blk.dtype), S.dist.padded_cols, a_blk)
        h = hadamard_transform(x)
        return _scaled(alpha, h[indices[ro:ro + rows].long()])
    return _tile_times(S, a_blk, rows, m, ro, 0, alpha,
                       _fused_ok(S, S.dist, a_blk, use_fused, rows, m))


def distributed_sketch_cols(S, A, mesh: DeviceMesh, *, alpha=1.0,
                            use_fused="auto") -> DTensor:
    """B = alpha * S @ A with A column-sharded over 'data' (the
    "sequence-parallel" layout for huge n): each rank computes its (d/model,
    n/data) output block from its columns of A and its row block of the
    operator, with no collective. Placements [Shard(0), Shard(1)]. Takes a
    DenseSkOp (differentiable in A) or a TrigSkOp (SRHT: the Hadamard
    transform acts along rows, so columns are independent)."""
    if not isinstance(S, TrigSkOp):
        require(isinstance(S, DenseSkOp), "takes a DenseSkOp or TrigSkOp")
        _require_x32(S)
    d, m = S.shape
    require(A.dim() == 2 and A.shape[0] == m,
            "A row count must equal S.n_cols")
    n = A.shape[1]
    shape, coord = _mesh(mesh)
    _, n_per = cols_extents(S, n, shape)
    a_blk = local_block(A, mesh, 1, n_per, coord[1])
    a_blk = replicated(a_blk, mesh.get_group("model"))
    out = cols_shard(S, a_blk, coord, shape, n, alpha=alpha,
                     use_fused=use_fused)
    return as_dtensor(out.contiguous(), mesh, [Shard(0), Shard(1)], (d, n))


def sparse_data_shard(S: DenseSkOp, coo, coord, shape, *,
                      alpha=1.0) -> torch.Tensor:
    """The partial of mesh position ``coord`` for B = alpha * S @ A by a
    dense operator and sparse data ``coo`` (COO, replicated): the (rows,
    cols) tile of S (K3 on the card) times the data's rows [co, co+cols]
    (their entries only), computed through the transpose, part^T =
    A_window^T @ tile^T, a sparse-left product with the index roles
    swapped."""
    from ..ops.coo_apply import coo_left_apply
    (mi, di), (d, m) = coord, S.shape
    n = coo.n_cols
    d_per, m_per = left_extents(S, shape)
    ro, rows = shard_span(d, d_per, mi)
    co, cols = shard_span(m, m_per, di)
    if rows == 0 or cols == 0:
        return coo.vals.new_zeros((rows, n), dtype=S.dtype)
    r, c, v = _entries_in(coo.rows, coo.cols, coo.vals, co, cols, 0, n)
    tile = S.submat(rows, cols, ro, co, device=v.device)
    return coo_left_apply(c, r, v.to(S.dtype), tile.T, n, cols, 0, co,
                          alpha).T


def distributed_sketch_sparse_data(S: DenseSkOp, A, mesh: DeviceMesh, *,
                                   alpha=1.0) -> DTensor:
    """B = alpha * S @ A for a dense operator and sparse data (COO, CSR or
    CSC, replicated on every rank): the operator's d rows over 'model', the
    data's m rows over 'data', partials added over 'data'. Placements
    [Shard(0), Replicate()]. Not differentiable."""
    from ..sparse_data.conversions import to_coo
    require(isinstance(S, DenseSkOp), "takes a DenseSkOp operator")
    _require_x32(S)
    coo = to_coo(A)
    require(S.n_cols == coo.n_rows, "operator width must equal data row count")
    shape, coord = _mesh(mesh)
    part = sparse_data_shard(S, coo, coord, shape, alpha=alpha)
    out = sum_over(part.contiguous(), mesh.get_group("data"))
    return as_dtensor(out, mesh, [Shard(0), Replicate()],
                      (S.n_rows, coo.n_cols))


def data_chunk(x, mesh: DeviceMesh, dim: int):
    """(local, offset): this rank's block of ``x`` along ``dim`` over
    'data' in DTensor's chunking (ceil(extent / data) a rank, the last ones
    shorter or empty) and its offset, clipped to the extent as
    ``shard_span`` clips it, through ``local_block``: a DTensor laid out
    [Replicate(), Shard(dim)] gives its local tensor with no collective."""
    shape, coord = _mesh(mesh)
    per = _shard_extent(x.shape[dim], shape[1])
    off = shard_span(x.shape[dim], per, coord[1])[0]
    return local_block(x, mesh, dim, per, coord[1]), min(off, x.shape[dim])


def data_sharded(local: torch.Tensor, mesh: DeviceMesh, dim: int,
                 shape) -> DTensor:
    """The DTensor of ``shape`` laid out [Replicate(), Shard(dim)] whose
    'data' chunks are the ranks' ``local`` blocks."""
    placements = [Replicate(), Shard(dim)]
    return as_dtensor(local.contiguous(), mesh, placements, shape)


def all_gather_rows(part: torch.Tensor, total: int, group) -> torch.Tensor:
    """The (total, ...) tensor whose DTensor chunks over ``group`` (rows)
    are the ranks' ``part``: each part zero-padded to the chunk extent, one
    all-gather, the padding dropped."""
    parts = dist.get_world_size(group)
    per = _shard_extent(total, parts)
    padded = part.new_zeros((per,) + tuple(part.shape[1:]))
    padded[:part.shape[0]] = part
    outs = [torch.empty_like(padded) for _ in range(parts)]
    dist.all_gather(outs, padded, group=group)
    return torch.cat(outs)[:total]


def owned_rows(blocks, off: int, idx: torch.Tensor, group):
    """Rows ``idx`` (global indices) of each tensor of ``blocks``, whose
    rows [off, off + len) this rank holds (the same rows in each),
    assembled over ``group`` with one all-reduce: each row has one owner
    and every other rank adds zeros, so the rows are exact. No sync with
    the host."""
    held, n_idx = blocks[0].shape[0], idx.shape[0]
    widths = [math.prod(x.shape[1:]) for x in blocks]
    if held == 0:
        part = blocks[0].new_zeros((n_idx, sum(widths)))
    else:
        loc = idx - off
        own = ((loc >= 0) & (loc < held))[:, None]
        at = loc.clamp(0, held - 1)
        picked = [x.reshape(held, -1).index_select(0, at) for x in blocks]
        rows = picked[0] if len(picked) == 1 else torch.cat(picked, dim=1)
        part = torch.where(own, rows, torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device))
    part = _all_reduce(part, group)
    out, start = [], 0
    for x, width in zip(blocks, widths):
        out.append(part[:, start:start + width].reshape(
            (n_idx,) + tuple(x.shape[1:])))
        start += width
    return tuple(out)


def replicated_on(t: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """``t``, the same on every rank, as a replicated DTensor on ``mesh``."""
    return as_dtensor(t.contiguous(), mesh, [Replicate(), Replicate()],
                      t.shape)


def gathered(x) -> torch.Tensor:
    """The full tensor of a DTensor (all-gathered), a plain tensor as it
    is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


__all__ = ["make_sketch_mesh", "distributed_sketch", "distributed_sketch_jit",
           "distributed_sketch_right", "distributed_sparse_sketch",
           "distributed_sketch_cols", "distributed_sketch_sparse_data"]
