"""The gather of material rows and its backward (``ptx_torch/kernels/
gather_cuda.py``): the plain version of the ``row_grad`` CUDA kernel against
autograd's own backward of ``table[idx]``, the kernel's order of sums, and
the rule that decides where the Function is used.

Tolerance: the plain version and autograd add the same terms in another
order, so each is held to the exact (float64) sum within its own float32
rounding bound, ``n * 2^-24 * sum |terms|`` per element, ``n`` the longest
chain of additions that order takes (the kernel's: rows per group, groups,
blocks per lane and the butterfly; autograd's: every row in turn).
"""

import numpy as np
import pytest
import torch

from ptx_torch import render
from ptx_torch.kernels import _build, gather_cuda
from ptx_torch.scene import bridge, textures
import _torch_port  # noqa: F401  (one intra-op thread per process)

EPS32 = 2.0 ** -24
COLS = 16
_GROUPS, _PER_BLOCK, _ = gather_cuda.grid(1, COLS)
ROWS = {"one": 1, "whole_blocks": 3 * _PER_BLOCK, "ragged": 5 * _PER_BLOCK + 7}


def _ids(case, rows, m, gen):
    if case == "one_material":
        return torch.full((rows,), m - 1, dtype=torch.int64)
    ids = torch.randint(0, m, (rows,), generator=gen)
    if case == "absent":  # the odd rows are never gathered
        ids = ids - ids % 2
    return ids


def _terms(rows, cols, gen, dtype=torch.float32):
    """Gradient rows whose magnitudes span many binades, so the order of a
    sum shows in its bits."""
    scale = torch.exp(torch.randn((rows, 1), generator=gen) * 4.0)
    return (torch.randn((rows, cols), generator=gen) * scale).to(dtype)


def _chain(rows, cols):
    """The longest chain of additions of the kernel's order."""
    groups, per_block, blocks = gather_cuda.grid(rows, cols)
    return per_block // groups + groups + -(-blocks // gather_cuda.LANES) + 5


def _within(got, exact, mag, n):
    return bool((np.abs(got.double().numpy() - exact) <= n * EPS32 * mag).all())


def _count_apply(monkeypatch):
    """A list that gains an entry at each call of ``GatherRows.apply``."""
    calls = []
    apply = gather_cuda.GatherRows.apply
    monkeypatch.setattr(gather_cuda.GatherRows, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    return calls


def _grad_through(fn, table, ids, weight):
    leaf = table.clone().requires_grad_(True)
    (fn(leaf, ids) * weight).sum().backward()
    return leaf.grad


@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("rows", sorted(ROWS), ids=sorted(ROWS))
@pytest.mark.parametrize("case", ["mixed", "one_material", "absent"])
def test_plain_backward_matches_autograd(m, rows, case, monkeypatch):
    gen = torch.Generator().manual_seed(m * 1000 + len(case))
    r = ROWS[rows]
    ids = _ids(case, r, m, gen)
    table = torch.randn((m, COLS), generator=gen)
    weight = _terms(r, COLS, gen)
    calls = _count_apply(monkeypatch)
    got = _grad_through(gather_cuda.gather_rows, table, ids, weight)
    want = _grad_through(lambda t, i: t[i], table, ids, weight)
    assert calls == [1]

    exact = np.zeros((m, COLS))
    mag = np.zeros((m, COLS))
    np.add.at(exact, ids.numpy(), weight.double().numpy())
    np.add.at(mag, ids.numpy(), np.abs(weight.double().numpy()))
    assert _within(got, exact, mag, _chain(r, COLS))
    assert _within(want, exact, mag, r)
    absent = np.setdiff1d(np.arange(m), ids.numpy())
    assert (got[absent] == 0).all()


def _kernel_order(grad, ids, m):
    """The loops of csrc/row_grad.cu written out one float32 addition at a
    time."""
    rows, cols = grad.shape
    groups, per_block, blocks = gather_cuda.grid(rows, cols)
    g32 = grad.numpy()
    ids = np.where(ids.numpy() < 0, ids.numpy() + m, ids.numpy())
    partial = np.zeros((blocks, m, cols), np.float32)
    for b in range(blocks):
        slices = np.zeros((groups, m, cols), np.float32)
        for r in range(b * per_block, min(rows, (b + 1) * per_block)):
            g = (r - b * per_block) % groups
            slices[g, ids[r]] = slices[g, ids[r]] + g32[r]
        acc = np.zeros((m, cols), np.float32)
        for g in range(groups):
            acc = acc + slices[g]
        partial[b] = acc
    lanes = np.zeros((gather_cuda.LANES, m, cols), np.float32)
    for b in range(blocks):
        lanes[b % gather_cuda.LANES] = lanes[b % gather_cuda.LANES] + partial[b]
    off = gather_cuda.LANES // 2
    while off:
        lanes = lanes[:off] + lanes[off:2 * off]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("rows,m,cols", [
    (1, 1, COLS), (3 * _PER_BLOCK, 4, COLS), (40 * _PER_BLOCK + 5, 4, COLS),
    (2000, 37, 3)])
def test_plain_takes_the_kernels_order(rows, m, cols):
    """Bit for bit: the same additions in the same order (more than 32
    blocks fill every lane; a width of 3 leaves threads of a block idle)."""
    gen = torch.Generator().manual_seed(rows + m)
    grad = _terms(rows, cols, gen)
    ids = torch.randint(-m, m, (rows,), generator=gen)
    got = gather_cuda.row_grad(grad, ids, m).numpy()
    want = _kernel_order(grad, ids, m)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_negative_ids_and_no_rows():
    gen = torch.Generator().manual_seed(3)
    table = torch.randn((5, COLS), generator=gen)
    ids = torch.randint(-5, 5, (300,), generator=gen)
    weight = _terms(300, COLS, gen)
    got = _grad_through(gather_cuda.GatherRows.apply, table, ids, weight)
    want = _grad_through(lambda t, i: t[i], table, ids, weight)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    empty = gather_cuda.row_grad(torch.zeros((0, COLS)),
                                 torch.zeros((0,), dtype=torch.int64), 5)
    assert empty.shape == (5, COLS) and (empty == 0).all()


def test_gradcheck_float64():
    gen = torch.Generator().manual_seed(5)
    table = torch.randn((4, COLS), generator=gen, dtype=torch.float64,
                        requires_grad=True)
    ids = torch.randint(0, 4, (3 * _PER_BLOCK + 3,), generator=gen)
    assert torch.autograd.gradcheck(gather_cuda.GatherRows.apply, (table, ids))


@pytest.mark.parametrize("rows", [0, 1, 128, 32768, 1 << 20, 5_000_001])
def test_grid_covers_the_rows(rows):
    groups, per_block, blocks = gather_cuda.grid(rows, COLS)
    assert groups * COLS == gather_cuda.THREADS
    assert per_block % groups == 0 and per_block >= gather_cuda.MIN_SWEEPS * groups
    assert 1 <= blocks <= gather_cuda.MAX_BLOCKS
    assert blocks * per_block >= rows > (blocks - 1) * per_block or rows == 0


@pytest.fixture(scope="module")
def scene():
    fs, static = render.load_scene("synthetic:200")
    return bridge.to_device(fs, "cpu"), static


def _lookup_calls(monkeypatch, fs, static, mat_id, grad_mode=True):
    calls = _count_apply(monkeypatch)
    uv = torch.zeros((mat_id.shape[0], 2))
    with torch.set_grad_enabled(grad_mode):
        mat = textures.material_lookup(fs, mat_id, uv, static)
    return calls, mat


def test_engage_rule(scene, monkeypatch):
    """The Function only under grad mode, for rows that require a gradient
    and fit the kernel's shared memory; else the plain gather and autograd's
    own backward."""
    fs, static = scene
    m = fs.mat_packed.shape[0]
    mat_id = torch.arange(64) % m
    leaf = fs.mat_packed.clone().requires_grad_(True)

    calls, _ = _lookup_calls(monkeypatch, fs, static, mat_id)
    assert calls == []  # no gradient on the rows
    calls, mat = _lookup_calls(monkeypatch, fs._replace(mat_packed=leaf),
                               static, mat_id, grad_mode=False)
    assert calls == [] and not mat["albedo"].requires_grad
    calls, mat = _lookup_calls(monkeypatch, fs._replace(mat_packed=leaf),
                               static, mat_id)
    assert calls == [1] and mat["albedo"].requires_grad

    big_m = gather_cuda.SHARED_BYTES // (gather_cuda.THREADS * 4) + 1
    assert gather_cuda.fits(big_m - 1, COLS) and not gather_cuda.fits(big_m, COLS)
    big = fs.mat_packed[torch.arange(big_m) % m].clone().requires_grad_(True)
    ids = torch.arange(300) % big_m
    calls, mat = _lookup_calls(monkeypatch, fs._replace(mat_packed=big),
                               static, ids)
    assert calls == []
    mat["albedo"].sum().backward()
    want = torch.zeros_like(big)
    want[:, 0:3] = torch.bincount(ids, minlength=big_m)[:, None].float()
    assert torch.equal(big.grad, want)
    assert _build.LAUNCHES["row_grad"] == 0  # the CPU launches no kernel
