"""The port's one-call API (``api.py``) on the CPU against the JAX package's
``neighbor_list(..., backend="dense")`` and ``backend="xla"`` on the same
numpy positions, and against the O(N^2) oracle: rows in the caller's order,
sentinel padding, capacity growth instead of truncation, and the JAX
package's ``backend="auto"`` rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import md_neighbor_list_tpu as jmdnl
import md_neighbor_list_tpu_torch as tmdnl
from md_neighbor_list_tpu.core.box import Box as JBox
from md_neighbor_list_tpu_torch.core import capacity as tcap
from md_neighbor_list_tpu_torch.core.box import Box as TBox
from md_neighbor_list_tpu_torch.ops import oracle as toracle
from torch_port_util import (RS, jax_decoder_build,  # noqa: F401
                             jax_native_decoder)


def _random_positions(n, rho, seed):
    box = TBox.from_density(n, rho)
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, box.L, (n, 3)).astype(np.float32), box


def _cluster(n=512, L=20.0):
    """Half of the particles inside one cell of the 7^3 grid, the rest
    uniform: the cell capacity has to grow from 40 to 304."""
    rng = np.random.default_rng(5)
    pos = np.concatenate([
        10.0 + 0.8 * rng.uniform(size=(n // 2, 3)),
        rng.uniform(0.0, L, (n - n // 2, 3))]).astype(np.float32)
    return pos, TBox(L=L)


def _oracle_pairs(pos, box, rs=RS, k_cap=128):
    idx, cnt = toracle.neighbors(torch.from_numpy(pos), box, rs, k_cap,
                                 half=True)
    assert int(cnt.max()) <= k_cap, "oracle helper truncated"
    return _pairset(idx.numpy())


def _pairset(idx):
    n = idx.shape[0]
    rows = np.repeat(np.arange(n)[:, None], idx.shape[1], 1)
    keep = idx < n
    i, j = rows[keep], idx[keep]
    return set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))


def _rowsets(idx):
    n = idx.shape[0]
    return [frozenset(row[row < n].tolist()) for row in idx]


def test_capacity_estimate_equals_the_jax_package():
    from md_neighbor_list_tpu.core import capacity as jcap

    for rho, rs, cell, half in ((1.0, 2.8, 2.9, True), (0.8, 2.5, 3.1, False),
                                (1.2, 3.0, 3.0, True)):
        got = tcap.estimate_neighbors(rho, rs, half)
        assert got == jcap.estimate(rho, rs, cell, half).neighbors
        assert got == tcap.estimate(rho, rs, cell, half).neighbors


@pytest.mark.usefixtures("jax_native_decoder")
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("n,seed", [(2000, 8), (700, 3)],
                         ids=["mc4", "mc3"])
def test_neighbor_list_equals_jax_dense_backend(n, seed, half):
    pos, box = _random_positions(n, 1.0, seed)
    idx_t, cnt_t = tmdnl.neighbor_list(pos, box, RS, half=half,
                                       backend="dense", device="cpu")
    idx_j, cnt_j = jmdnl.neighbor_list(jnp.asarray(pos), JBox(L=box.L), RS,
                                       half=half, backend="dense")
    assert idx_t.dtype == torch.int32 and cnt_t.dtype == torch.int32
    assert tuple(idx_t.shape) == tuple(idx_j.shape) and cnt_t.shape == (n,)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert _rowsets(idx_t.numpy()) == _rowsets(np.asarray(idx_j))
    # the native walk is the same in both packages: equal slot by slot
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert _pairset(idx_t.numpy()) == _oracle_pairs(pos, box)
    if not half:
        want_idx, want_cnt = toracle.neighbors(torch.from_numpy(pos), box, RS,
                                               128, half=False)
        assert torch.equal(cnt_t, want_cnt)
        assert _rowsets(idx_t.numpy()) == _rowsets(want_idx.numpy())


@pytest.mark.parametrize("backend", ["xla", "dense"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_list_matches_oracle(seed, backend):
    pos, box = _random_positions(2000, 1.0, seed)
    i, j = tmdnl.pair_list(pos, box, RS, backend=backend, device="cpu")
    assert i.dtype == np.int32 and (i < j).all()
    got = set(zip(i.tolist(), j.tolist()))
    assert len(got) == len(i), "duplicate pairs"
    assert got == _oracle_pairs(pos, box)
    assert len(i) == int(toracle.pair_count(torch.from_numpy(pos), box, RS))


def test_auto_backend_takes_the_dense_engine_when_the_grid_allows():
    """``backend="auto"`` routes by the JAX package's rule: the dense engine
    only off the CPU, at N >= DENSE_API_MIN_N and on a box of at least 3
    cells a side; on the CPU it is the sweep, equal to ``backend="xla"``.
    The card's branch is the pure routing function, at N below and above
    the crossover."""
    from md_neighbor_list_tpu_torch import api

    assert api.DENSE_API_MIN_N == jmdnl.api.DENSE_API_MIN_N == 500_000
    pos, box = _random_positions(1500, 0.8, 2)
    a = tmdnl.neighbor_list(pos, box, 2.5, device="cpu")
    x = tmdnl.neighbor_list(pos, box, 2.5, backend="xla", device="cpu")
    assert torch.equal(a[0], x[0]) and torch.equal(a[1], x[1])
    big = api.DENSE_API_MIN_N
    L = 100.0  # 40 cells of 2.5 a side
    assert not api.use_dense("auto", "cpu", 10 * big, L, 2.5)
    assert not api.use_dense("auto", "cuda", big - 1, L, 2.5)
    assert api.use_dense("auto", "cuda", big, L, 2.5)
    assert not api.use_dense("auto", "cuda", big, 7.4, 2.5)  # 2 cells
    assert api.use_dense("dense", "cpu", 10, 7.4, 2.5)
    assert not api.use_dense("xla", "cuda", 10 * big, L, 2.5)


def test_scalar_box_tensor_input_and_tiny_system_through_the_oracle():
    """A float L works as the box and a tensor as positions; a box with
    fewer than 3 cells per side takes the all-pairs route under "auto" and
    still gives oracle-exact pairs, where "dense" raises."""
    pos, box = _random_positions(64, 1.0, 3)  # L = 4 -> mc = 1 at rs = 2.8
    i, j = tmdnl.pair_list(torch.from_numpy(pos), box.L, RS, device="cpu")
    assert set(zip(i.tolist(), j.tolist())) == _oracle_pairs(pos, box)
    idx, cnt = tmdnl.neighbor_list(pos, box.L, RS, device="cpu")
    want_idx, want_cnt = jmdnl.neighbor_list(jnp.asarray(pos), box.L, RS)
    assert tuple(idx.shape) == tuple(want_idx.shape)  # same grow-k loop
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    with pytest.raises(ValueError, match="too small"):
        tmdnl.neighbor_list(pos, box, RS, backend="dense", device="cpu")
    with pytest.raises(ValueError, match="k_cap"):
        tmdnl.neighbor_list(pos, box, RS, k_cap=4, device="cpu")


@pytest.mark.parametrize("backend", ["xla", "dense"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_explicit_k_cap_overflow_raises(half, backend):
    pos, box = _random_positions(2000, 1.0, 9)
    with pytest.raises(ValueError, match="k_cap"):
        tmdnl.neighbor_list(pos, box, RS, half=half, k_cap=4,
                            backend=backend, device="cpu")
    idx, cnt = tmdnl.neighbor_list(pos, box, RS, half=half, k_cap=160,
                                   backend=backend, device="cpu")
    assert tuple(idx.shape) == (2000, 160) and int(cnt.max()) <= 160


def test_unwrapped_positions_bin_correctly():
    pos, box = _random_positions(400, 1.0, 7)
    want = _oracle_pairs(pos, box)
    shift = np.where(np.arange(400)[:, None] < 100, np.float32(box.L),
                     np.float32(0.0))
    for moved in (pos + shift, pos - shift):
        i, j = tmdnl.pair_list(moved, box, RS, device="cpu")
        assert set(zip(i.tolist(), j.tolist())) == want


def test_empty_input():
    idx, cnt = tmdnl.neighbor_list(np.zeros((0, 3), np.float32), 10.0, RS,
                                   device="cpu")
    assert tuple(idx.shape) == (0, 8) and tuple(cnt.shape) == (0,)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    idx, _ = tmdnl.neighbor_list(np.zeros((0, 3), np.float32), 10.0, RS,
                                 k_cap=24, device="cpu")
    assert tuple(idx.shape) == (0, 24)
    i, j = tmdnl.pair_list(np.zeros((0, 3), np.float32), 10.0, RS,
                           device="cpu")
    assert i.size == 0 and j.size == 0


def test_cell_capacity_grows_on_a_cluster():
    """256 particles in one cell: the dense engine's cap grows 40 -> ... ->
    304 and the lists stay complete (held against the oracle; the JAX
    kernels in interpret mode are too slow at that capacity)."""
    pos, box = _cluster()
    i, j = tmdnl.pair_list(pos, box, RS, backend="dense", device="cpu")
    assert set(zip(i.tolist(), j.tolist())) == _oracle_pairs(pos, box,
                                                             k_cap=320)
    idx, cnt = tmdnl.neighbor_list(pos, box, RS, half=True, k_cap=320,
                                   backend="dense", device="cpu")
    assert int(cnt.max()) <= 320
    assert _pairset(idx.numpy()) == _oracle_pairs(pos, box, k_cap=320)


def test_unported_backend_and_bad_arguments_raise():
    pos, box = _random_positions(400, 1.0, 1)
    with pytest.raises(ValueError, match="backend"):
        tmdnl.neighbor_list(pos, box, RS, backend="pallas", device="cpu")
    with pytest.raises(TypeError):
        tmdnl.pair_list(pos, box, RS, half=False, device="cpu")
    pos, box = _random_positions(2000, 1.0, 1)  # a grid: the sweep bins
    with pytest.raises(ValueError, match="layout"):
        tmdnl.pair_list(pos, box, RS, layout="hilbert", backend="xla",
                        device="cpu")


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("n,seed", [(2000, 8), (700, 3), (64, 3)],
                         ids=["mc4", "mc3", "oracle"])
def test_xla_backend_bitwise_equals_jax_xla_backend(n, seed, half, layout):
    """``backend="xla"`` against the JAX package's, shape included: the
    density estimate of K, the stable sweep (or the oracle for mc < 3) and
    the rows in the caller's order bit for bit; ``pair_list`` likewise."""
    pos, box = _random_positions(n, 1.0, seed)
    idx_t, cnt_t = tmdnl.neighbor_list(pos, box, RS, half=half, layout=layout,
                                       backend="xla", device="cpu")
    idx_j, cnt_j = jmdnl.neighbor_list(jnp.asarray(pos), JBox(L=box.L), RS,
                                       half=half, layout=layout,
                                       backend="xla")
    assert idx_t.dtype == torch.int32 and cnt_t.dtype == torch.int32
    assert tuple(idx_t.shape) == tuple(idx_j.shape)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    if half:
        it, jt = tmdnl.pair_list(pos, box, RS, layout=layout, backend="xla",
                                 device="cpu")
        ij, jj = jmdnl.pair_list(jnp.asarray(pos), box.L, RS, layout=layout,
                                 backend="xla")
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(jt, jj)


def test_xla_backend_grows_like_jax_xla_backend():
    """A cell table too small for the cluster grows even under an explicit
    k_cap, and K grows from the estimate when left to default: the same
    shapes and rows as the JAX package."""
    pos, box = _cluster()
    for k_cap in (None, 320):
        idx_t, cnt_t = tmdnl.neighbor_list(pos, box, RS, half=True,
                                           k_cap=k_cap, backend="xla",
                                           device="cpu")
        idx_j, cnt_j = jmdnl.neighbor_list(jnp.asarray(pos), JBox(L=box.L),
                                           RS, half=True, k_cap=k_cap,
                                           backend="xla")
        assert tuple(idx_t.shape) == tuple(idx_j.shape)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert idx_t.shape[1] == 320
    assert _pairset(idx_t.numpy()) == _oracle_pairs(pos, box, k_cap=320)
