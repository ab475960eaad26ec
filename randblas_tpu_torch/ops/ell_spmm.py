"""BlockedELL SpMM, K5: C = alpha * E @ B for sparse data E (counterpart of
randblas_tpu/ops/ell_spmm.py).

**BlockedELL**: for each (row, column block of kb) pair, exactly bw slots
(column local to the block, value), padded with (-1, 0), stored slot-major
as (n_kblocks * bw, m_pad) tables. The container, its host-side
construction ``from_ell`` and its fields are the JAX package's, so the
tables compare element for element.

``blocked_ell_matmul`` launches ``ell_spmm_kernel`` (``csrc/ell_spmm.cu``)
on a CUDA tensor and runs the plain version on a CPU one. Both round B and
the values to bf16 and sum each output row in float32 in (column block,
slot) order, so they agree to the bit. (The JAX kernel rounds each summed
panel value to bf16, which differs only where a row repeats a column inside
one block.) The COO overflow of a ``bw_cap`` table is added outside the
kernel in float32, with ``index_add_``. Launches are counted in
``blocked_ell_matmul.launches``.

A word-major table (``word_major=W``) indexes B in word-major storage
order; the product takes B in that order (``b_order="storage"``, the JAX
package's convention) or in natural order (``b_order="natural"``), which
the kernel reads through the map storage row s -> natural row
(s % nblk) * W + s // nblk, nblk = ceil(n_cols / W).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..base import require
from . import _build

_VEC = 8   # the kernel reads B rows 8 bf16 at a time: B's row stride


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedELL:
    """Slot tables local_cols / vals of shape (n_kblocks * bw, m_pad): row
    r's slots for column block b are rows b*bw .. b*bw+bw-1, column r.

    Two-tier form (``bw_cap`` in ``from_ell``): entries beyond slot bw_cap
    of a (row, block) group live in the ``ovf_*`` COO arrays.

    ``word_major`` = W > 0: the tables index B's rows in word-major storage
    order, where storage row s = (k % W) * ceil(n_cols / W) + k // W holds
    natural row k.
    """
    local_cols: torch.Tensor   # int32, -1 = empty slot
    vals: torch.Tensor         # float32
    n_rows: int
    n_cols: int
    kb: int
    bw: int
    ovf_rows: torch.Tensor = None
    ovf_cols: torch.Tensor = None
    ovf_vals: torch.Tensor = None
    word_major: int = 0

    def __post_init__(self):
        dev = self.local_cols.device
        for name, dtype in (("ovf_rows", torch.int32),
                            ("ovf_cols", torch.int32),
                            ("ovf_vals", torch.float32)):
            if getattr(self, name) is None:
                object.__setattr__(self, name,
                                   torch.zeros((0,), dtype=dtype, device=dev))

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.local_cols.device

    @property
    def n_kblocks(self) -> int:
        return self.local_cols.shape[0] // self.bw

    @property
    def ovf_nnz(self) -> int:
        return self.ovf_rows.shape[0]

    @property
    def b_rows(self) -> int:
        """Row count of the B operand in storage order."""
        if self.word_major:
            w = self.word_major
            return w * (-(-self.n_cols // w))
        return self.n_cols

    @staticmethod
    def from_ell(ell, kb: int = 128, ti: int = 2048, bw_cap: int = None,
                 word_major: int = 0, device=None) -> "BlockedELL":
        """One-time host-side conversion (numpy), onto ``device`` (the
        ELL's by default). Zero-valued ELL slots are padding and dropped.
        bw_cap: cap the slots per (row, block); the excess goes to the COO
        overflow arrays. word_major: build the tables against word-major B
        storage order (pass the RNG counter width, 4)."""
        cols = ell.colidxs.cpu().numpy()
        vals = ell.vals.cpu().numpy().astype(np.float32)
        m, k = ell.shape
        m_pad = -(-max(m, 8) // ti) * ti if m >= ti else -(-m // 8) * 8
        k_store = word_major * (-(-k // word_major)) if word_major else k
        n_k = -(-k_store // kb)

        rows = np.repeat(np.arange(m, dtype=np.int64), cols.shape[1])
        c = cols.reshape(-1).astype(np.int64)
        v = vals.reshape(-1)
        keep = v != 0
        rows, c, v = rows[keep], c[keep], v[keep]
        if word_major:
            nblk = k_store // word_major
            c = (c % word_major) * nblk + c // word_major
        blk = c // kb
        key = rows * n_k + blk
        order = np.argsort(key, kind="stable")
        sk = key[order]
        starts = np.searchsorted(sk, np.arange(m * n_k))
        slot = np.arange(len(sk)) - starts[sk]

        ovf = np.zeros(len(sk), dtype=bool)
        if bw_cap is not None and (slot >= bw_cap).any():
            ovf = slot >= bw_cap
            bw = bw_cap
        else:
            bw = int(slot.max(initial=-1)) + 1
            if bw_cap is not None:
                bw = min(max(bw, 1), bw_cap)
            else:
                bw = max(-(-bw // 8) * 8, 8)

        tab_c = np.full((m_pad, n_k * bw), -1, dtype=np.int32)
        tab_v = np.zeros((m_pad, n_k * bw), dtype=np.float32)
        in_t = ~ovf
        r_o, c_o, v_o = rows[order], c[order], v[order]
        pos = blk[order][in_t] * bw + slot[in_t]
        tab_c[r_o[in_t], pos] = (c_o[in_t] % kb).astype(np.int32)
        tab_v[r_o[in_t], pos] = v_o[in_t]
        dev = ell.device if device is None else torch.device(device)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        # overflow columns stay in storage order, as the tables' are
        return BlockedELL(put(tab_c.T), put(tab_v.T), m, k, kb, bw,
                          put(r_o[ovf].astype(np.int32)),
                          put(c_o[ovf].astype(np.int32)), put(v_o[ovf]),
                          word_major)

    def natural_rows(self, storage) -> torch.Tensor:
        """The natural B row of each storage row index."""
        if not self.word_major:
            return storage
        nblk = self.b_rows // self.word_major
        return (storage % nblk) * self.word_major + storage // nblk

    def to_coo(self):
        """Host-side conversion back to COO, through the dense matrix."""
        from ..sparse_data.coo import COOMatrix
        return COOMatrix.from_dense(self.to_dense())

    def to_dense(self) -> torch.Tensor:
        n_k = self.n_kblocks
        ci = self.local_cols.cpu().numpy().T   # (m_pad, n_k * bw)
        v = self.vals.cpu().numpy().T
        dense = np.zeros((ci.shape[0], n_k * self.kb), np.float32)
        for b in range(n_k):
            sl = slice(b * self.bw, (b + 1) * self.bw)
            c = ci[:, sl]
            r, s = np.nonzero(c >= 0)
            np.add.at(dense, (r, b * self.kb + c[r, s]), v[:, sl][r, s])
        if self.ovf_nnz:
            np.add.at(dense, (self.ovf_rows.cpu().numpy(),
                              self.ovf_cols.cpu().numpy()),
                      self.ovf_vals.cpu().numpy())
        dense = dense[:self.n_rows]
        if self.word_major:
            k = np.arange(self.n_cols)
            nblk = self.b_rows // self.word_major
            dense = dense[:, (k % self.word_major) * nblk
                          + k // self.word_major]
        else:
            dense = dense[:, :self.n_cols]
        return torch.from_numpy(np.ascontiguousarray(dense)).to(self.device)


def to_word_major_rows(b: torch.Tensor, w: int, n_cols: int) -> torch.Tensor:
    """A natural-row-order operand (n_cols, n) in word-major storage order
    (w * ceil(n_cols / w), n): storage row (k % w) * nblk + k // w holds
    natural row k."""
    nblk = -(-n_cols // w)
    if b.shape[0] != w * nblk:
        b = torch.cat([b, b.new_zeros((w * nblk - b.shape[0], b.shape[1]))])
    return b.reshape(nblk, w, b.shape[1]).transpose(0, 1).reshape(
        w * nblk, b.shape[1])


def _tables_reference(bell: BlockedELL, b: torch.Tensor, alpha,
                      natural: bool) -> torch.Tensor:
    """The plain version of K5 itself: B and the values rounded to bf16,
    every slot's term added into its row in (column block, slot) order,
    float32 sums."""
    m = bell.n_rows
    b_f = b.to(torch.bfloat16).to(torch.float32)
    ci = bell.local_cols[:, :m].to(b.device)
    v = bell.vals[:, :m].to(b.device).to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=b.device)
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    for slot in range(ci.shape[0]):
        c = ci[slot].long()
        ok = c >= 0
        row = (slot // bell.bw) * bell.kb + c
        if natural:
            row = bell.natural_rows(row)
        row = torch.where(ok, row, 0)
        acc = acc + torch.where(ok, v[slot], zero)[:, None] * b_f[row]
    if alpha != 1.0:
        acc = acc * torch.tensor(float(alpha), dtype=torch.float32)
    return acc


def _with_overflow(out, bell: BlockedELL, b: torch.Tensor, alpha,
                   natural: bool) -> torch.Tensor:
    """out plus the COO overflow's product, in float32 (index_add_)."""
    if not bell.ovf_nnz:
        return out
    from .coo_apply import coo_left_apply
    cols = bell.ovf_cols.to(b.device).long()
    if natural:
        cols = bell.natural_rows(cols)
    return out + coo_left_apply(
        bell.ovf_rows.to(b.device), cols, bell.ovf_vals.to(b.device),
        b.to(torch.float32), bell.n_rows, b.shape[0], alpha=alpha)


def blocked_ell_reference(bell: BlockedELL, b: torch.Tensor, alpha=1.0,
                          b_order: str = "storage") -> torch.Tensor:
    """The plain PyTorch version of ``blocked_ell_matmul`` on b's device:
    the tables' product as K5 computes it, plus the COO overflow."""
    natural = _check_order(bell, b, b_order)
    return _with_overflow(_tables_reference(bell, b, alpha, natural), bell,
                          b, alpha, natural)


def _check_order(bell: BlockedELL, b: torch.Tensor, b_order: str) -> bool:
    """True when b is in natural order and the tables are word-major."""
    require(b_order in ("storage", "natural"),
            f"b_order is 'storage' or 'natural', not {b_order!r}")
    natural = b_order == "natural" and bell.word_major > 0
    rows = bell.n_cols if natural else bell.b_rows
    require(b.dim() == 2 and b.shape[0] == rows,
            f"operand height must be {rows} (b_rows in storage order, "
            "n_cols in natural order)")
    return natural


def _launch(bell: BlockedELL, b: torch.Tensor, alpha, natural: bool):
    if bell.local_cols.device != b.device:
        raise ValueError("K5 takes the tables and B on one CUDA device")
    m, n = bell.n_rows, b.shape[1]
    ldb = -(-n // _VEC) * _VEC
    ci = bell.local_cols.to(torch.int32).contiguous()
    v = bell.vals.to(torch.float32).contiguous()
    lib = _build.load()
    with torch.cuda.device(b.device):
        if ldb == n:   # one conversion pass; a no-op for bf16 B
            b_bf = b.to(torch.bfloat16).contiguous()
        else:          # rows padded to whole 16-byte loads
            b_bf = torch.zeros((b.shape[0], ldb), dtype=torch.bfloat16,
                               device=b.device)
            b_bf[:, :n] = b
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        stream = torch.cuda.current_stream(b.device).cuda_stream
        code = lib.rbt_ell_spmm(
            ci.data_ptr(), v.data_ptr(), ci.shape[1], ci.shape[0], bell.bw,
            bell.kb, b_bf.data_ptr(), ldb, b.shape[0], out.data_ptr(), m, n,
            bell.word_major if natural else 0,
            bell.b_rows // bell.word_major if natural else 0,
            float(alpha), ctypes.c_void_p(stream))
        blocked_ell_matmul.launches += 1
    _build.check(code, "ell_spmm_kernel launch")
    return out


def blocked_ell_matmul(bell: BlockedELL, b: torch.Tensor, alpha=1.0,
                       b_order: str = "storage") -> torch.Tensor:
    """alpha * bell @ b: the tables through K5 (CUDA tensors) or its plain
    version (CPU tensors), then the COO overflow in float32.

    b: (bell.b_rows, n) in storage order, or (bell.n_cols, n) in natural
    order with ``b_order="natural"`` (the same for a table that is not
    word-major), float32 or bf16. Returns (n_rows, n) float32."""
    b = torch.as_tensor(b)
    natural = _check_order(bell, b, b_order)
    if b.is_cuda:
        out = _launch(bell, b, alpha, natural)
    elif b.device.type == "cpu":
        out = _tables_reference(bell, b, alpha, natural)
    else:
        raise ValueError(f"no BlockedELL kernel for {b.device}")
    return _with_overflow(out, bell, b, alpha, natural)


blocked_ell_matmul.launches = 0
