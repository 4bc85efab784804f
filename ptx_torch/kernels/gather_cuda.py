"""The gather of table rows whose backward is a hand-written CUDA kernel.

* :func:`gather_rows` - ``table[idx]``: the forward is the gather itself,
  so every value a render sees is the same; the backward sums the
  gradient rows into the table's rows by id with :func:`row_grad`.
* :func:`row_grad` - ``csrc/row_grad.cu::ptx_row_grad``, plain version
  :func:`row_grad_plain`: ``out[idx[r]] += grad[r]`` in two deterministic
  passes (block sums into shared memory, then a sum over the blocks), with
  no sort and no float atomics.  It replaces autograd's backward of the
  gather (``index_put_`` with accumulate), which sorts the ids and adds
  each run of equal ids serially: with a scene's few materials a wavefront
  is a few long runs.

:func:`gather_rows` takes the Function only where it pays and the kernel
holds the table: under grad mode, for a float32 [M, C] table that
requires a gradient and whose ``G x M x C`` floats fit a block's shared
memory (:func:`fits`: C = 16, M up to 227).  Otherwise it is
``table[idx]`` with autograd's own backward: a render without gradients
runs exactly the gather it ran before, and a table of many rows keeps the
sorted scatter, which does not serialise on many distinct ids.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (and counts the call in
``_build.LAUNCHES["row_grad"]``: one per backward, its two kernels) or
raises.  The plain version takes the kernel's sums in the kernel's order,
so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from ptx_torch.kernels import _build

# Threads of a block of csrc/row_grad.cu; a block is THREADS // C groups
# of C threads.  A block walks at least MIN_SWEEPS rows per group, and the
# grid holds at most MAX_BLOCKS blocks (about eight of 256 threads on each
# of an H100's 132 SMs).  SHARED_BYTES: the shared memory a block may ask
# for on Hopper (227 KB).
THREADS = 256
LANES = 32
MIN_SWEEPS = 8
MAX_BLOCKS = 1024
SHARED_BYTES = 232448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid(rows: int, cols: int):
    """``(groups, per_block, blocks)`` of the kernel for ``rows`` x
    ``cols`` gradients: set by the shapes alone."""
    groups = THREADS // cols
    per_block = max(MIN_SWEEPS, _cdiv(_cdiv(rows, groups), MAX_BLOCKS)) * groups
    return groups, per_block, max(1, _cdiv(rows, per_block))


def fits(m: int, cols: int) -> bool:
    """Whether a block's ``groups`` slices of [m, cols] floats fit its
    shared memory."""
    return 0 < cols <= THREADS and (THREADS // cols) * m * cols * 4 <= SHARED_BYTES


def row_grad_plain(grad, idx, m: int):
    """[m, C]: ``grad`` [R, C] summed by ``idx`` [R], in the kernel's order.
    Each block's group slot is one ``index_add_`` target (which adds its
    rows in row order), then the groups in order, then the blocks per lane
    and the lanes' butterfly."""
    rows, cols = grad.shape
    groups, per_block, blocks = grid(rows, cols)
    idx = torch.where(idx < 0, idx + m, idx)
    r = torch.arange(rows, device=grad.device)
    slot = (r // per_block) * groups + r % groups
    slices = torch.zeros((blocks * groups * m, cols), dtype=grad.dtype,
                         device=grad.device).index_add_(0, slot * m + idx, grad)
    slices = slices.view(blocks, groups, m, cols)
    part = torch.zeros((blocks, m, cols), dtype=grad.dtype, device=grad.device)
    for g in range(groups):
        part = part + slices[:, g]
    lanes = torch.zeros((LANES, m, cols), dtype=grad.dtype, device=grad.device)
    for b in range(0, blocks, LANES):
        n = min(LANES, blocks - b)
        lanes = torch.cat([lanes[:n] + part[b:b + n], lanes[n:]])
    off = LANES // 2
    while off:
        lanes = lanes[:off] + lanes[off:2 * off]
        off //= 2
    return lanes[0]


def row_grad(grad, idx, m: int):
    """[m, C] float32: the gradient rows ``grad`` [R, C] summed by ``idx``
    [R] int64 (:func:`row_grad_plain` on the CPU)."""
    if _build.on_cpu(grad, idx):
        return row_grad_plain(grad, idx, m)
    rows, cols = grad.shape
    _build.check(grad, "grad", torch.float32, (rows, cols))
    _build.check(idx, "idx", torch.int64, (rows,))
    if not fits(m, cols):
        raise ValueError(f"[{m}, {cols}] slices do not fit a block's shared memory")
    out = torch.empty((m, cols), dtype=torch.float32, device=grad.device)
    if rows == 0:
        return out.zero_()
    groups, per_block, blocks = grid(rows, cols)
    partial = torch.empty((blocks, m, cols), dtype=torch.float32,
                          device=grad.device)
    _build.launch(_build.load().ptx_row_grad, grad.data_ptr(), idx.data_ptr(),
                  rows, m, cols, groups, per_block, blocks,
                  partial.data_ptr(), out.data_ptr())
    _build.LAUNCHES["row_grad"] += 1
    return out


class GatherRows(torch.autograd.Function):
    """``table[idx]``, whose backward is :func:`row_grad`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.m = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return row_grad(grad.contiguous(), idx, ctx.m), None


def gather_rows(table, idx):
    """``table[idx]`` for ``idx`` [R] int64; through :class:`GatherRows`
    under grad mode for a float32 [M, C] table that requires a gradient
    and :func:`fits`."""
    if (torch.is_grad_enabled() and table.requires_grad and table.dim() == 2
            and table.dtype == torch.float32 and fits(*table.shape)):
        return GatherRows.apply(table, idx)
    return table[idx]
