"""The port's mask decoders (``ops/decode.py``, ``utils/native.py`` +
``csrc/decode.cpp``) against the JAX package's, on masks made by either
package: every decode output is bitwise the same whichever decoder reads
whichever artifact, and the C++ walker equals the numpy path."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.ops import decode as jdec
from md_neighbor_list_tpu.ops import pallas_force as jpf
from md_neighbor_list_tpu_torch.ops import decode as tdec
from md_neighbor_list_tpu_torch.ops import dense_force as tdf
from md_neighbor_list_tpu_torch.utils import convert, native
from torch_port_util import (CASES, RS, jax_decoder_build,  # noqa: F401
                             jax_native_decoder, rebuilt_pair)

ALL = sorted(CASES)
IMPLS = ["native", "numpy"]


@functools.lru_cache(maxsize=None)
def _artifacts(case):
    """(jax masks, jax pid, jax spec, port masks, port pid, port spec, total
    pairs): each package's list build on the same rebuilt state."""
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    jv = js.valid().astype(jnp.float32)
    _, j_masks = jpf.dense_lists_half(js.pos, jv, jspec, RS, True)
    t_counts, t_masks = tdf.dense_lists_half(ts.pos, tspec, RS)
    total = int(t_counts[ts.valid()].sum())
    return np.asarray(j_masks), np.asarray(js.pid), jspec, t_masks, ts.pid, \
        tspec, total


def _canon(own, partner):
    lo = np.minimum(own, partner)
    hi = np.maximum(own, partner)
    order = np.lexsort((hi, lo))
    return np.stack([lo[order], hi[order]])


def test_constants_and_no_auto_impl():
    assert tdec.HALF_OFFSETS5 == jdec.HALF_OFFSETS5
    assert tdec.MASK_BITS == jdec.MASK_BITS
    _, _, _, t_masks, t_pid, tspec, _ = _artifacts("mc4_cap32")
    # the port has no automatic choice of decoder: the caller names it
    with pytest.raises(ValueError, match="impl"):
        tdec.decode_pairs(t_masks, t_pid, tspec, impl="auto")
    with pytest.raises(ValueError, match="impl"):
        tdec.masks_to_padded(t_masks, t_pid, tspec, impl="auto")


def test_native_decoder_builds_here():
    lib = native.load()
    assert lib is native.load()  # cached
    assert native.BUILD.name == "build" and any(
        native.BUILD.glob("libmdnl-decode-*.so"))


@pytest.mark.usefixtures("jax_native_decoder")
@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("impl", IMPLS)
def test_pid_pairs_bitwise_across_packages(case, impl):
    j_masks, j_pid, jspec, t_masks, t_pid, tspec, total = _artifacts(case)
    want = jdec._decode_pid_pairs(j_masks, j_pid, jspec, impl="numpy")
    # port decoder on its own masks, and on the JAX package's masks
    for masks, pid in ((t_masks, t_pid), (j_masks, j_pid)):
        got = tdec._decode_pid_pairs(masks, pid, tspec, impl=impl)
        assert got[0].size == total
        if impl == "numpy":  # same walk order: equal element by element
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        else:
            np.testing.assert_array_equal(_canon(*got), _canon(*want))
            size = np.int64(j_pid.size)
            np.testing.assert_array_equal(
                np.sort(got[0] * size + got[1]),
                np.sort(want[0] * size + want[1]))
    # JAX decoder on the port's masks: the same walk, element by element
    theirs = jdec._decode_pid_pairs(t_masks.numpy(), t_pid.numpy(), jspec,
                                    impl=impl)
    ours = tdec._decode_pid_pairs(t_masks, t_pid, tspec, impl=impl)
    np.testing.assert_array_equal(theirs[0], ours[0])
    np.testing.assert_array_equal(theirs[1], ours[1])


@pytest.mark.usefixtures("jax_native_decoder")
@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("impl", IMPLS)
def test_decode_pairs_bitwise(case, impl):
    j_masks, j_pid, jspec, t_masks, t_pid, tspec, total = _artifacts(case)
    i_t, j_t = tdec.decode_pairs(t_masks, t_pid, tspec, impl=impl)
    i_j, j_j = jdec.decode_pairs(j_masks, j_pid, jspec, impl=impl)
    assert i_t.dtype == np.int32 and i_t.size == total
    assert (i_t < j_t).all()
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(j_t, j_j)
    # each package's decoder on the other's masks
    i_x, j_x = tdec.decode_pairs(j_masks, j_pid, tspec, impl=impl)
    i_y, j_y = jdec.decode_pairs(t_masks.numpy(), t_pid.numpy(), jspec,
                                 impl=impl)
    for a in (i_x, i_y):
        np.testing.assert_array_equal(a, i_t)
    for a in (j_x, j_y):
        np.testing.assert_array_equal(a, j_t)
    assert len(set(zip(i_t.tolist(), j_t.tolist()))) == total  # no duplicate


@pytest.mark.usefixtures("jax_native_decoder")
@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("full", [False, True], ids=["half", "full"])
def test_masks_to_padded_bitwise(case, impl, full):
    j_masks, j_pid, jspec, t_masks, t_pid, tspec, total = _artifacts(case)
    n = CASES[case][0]
    idx_t, cnt_t = tdec.masks_to_padded(t_masks, t_pid, tspec, impl=impl,
                                        full=full)
    idx_j, cnt_j = jdec.masks_to_padded(j_masks, j_pid, jspec, impl=impl,
                                        full=full)
    assert idx_t.dtype == np.int32 and cnt_t.dtype == np.int32
    assert idx_t.shape[0] == n and idx_t.shape[1] % 8 == 0
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    assert int(cnt_t.sum()) == (2 if full else 1) * total
    assert ((idx_t < n).sum(axis=1) == cnt_t).all()  # sentinel n pads
    # across packages, and explicit n and k_cap
    idx_x, cnt_x = tdec.masks_to_padded(j_masks, j_pid, tspec, n=n,
                                        k_cap=idx_t.shape[1], impl=impl,
                                        full=full)
    idx_y, cnt_y = jdec.masks_to_padded(t_masks.numpy(), t_pid.numpy(),
                                        jspec, n=n, k_cap=idx_t.shape[1],
                                        impl=impl, full=full)
    for a in (idx_x, idx_y):
        np.testing.assert_array_equal(a, idx_t)
    for a in (cnt_x, cnt_y):
        np.testing.assert_array_equal(a, cnt_t)


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("full", [False, True], ids=["half", "full"])
def test_native_equals_numpy(case, full):
    _, _, _, t_masks, t_pid, tspec, _ = _artifacts(case)
    idx_n, cnt_n = tdec.masks_to_padded(t_masks, t_pid, tspec, impl="native",
                                        full=full)
    idx_r, cnt_r = tdec.masks_to_padded(t_masks, t_pid, tspec, impl="numpy",
                                        full=full)
    np.testing.assert_array_equal(cnt_n, cnt_r)
    assert idx_n.shape == idx_r.shape
    np.testing.assert_array_equal(np.sort(idx_n, axis=1),
                                  np.sort(idx_r, axis=1))
    i_n, j_n = tdec.decode_pairs(t_masks, t_pid, tspec, impl="native")
    i_r, j_r = tdec.decode_pairs(t_masks, t_pid, tspec, impl="numpy")
    np.testing.assert_array_equal(_canon(i_n, j_n), _canon(i_r, j_r))


@pytest.mark.parametrize("impl", IMPLS)
def test_explicit_n_widens_rows_and_small_n_raises(impl):
    _, _, _, t_masks, t_pid, tspec, _ = _artifacts("mc4_cap40")
    n = CASES["mc4_cap40"][0]
    idx, cnt = tdec.masks_to_padded(t_masks, t_pid, tspec, n=n + 5, impl=impl)
    assert idx.shape[0] == n + 5 and int(cnt[n:].sum()) == 0
    assert (idx[n:] == n + 5).all()  # the sentinel follows n
    with pytest.raises(ValueError, match="smaller than max decoded pid"):
        tdec.masks_to_padded(t_masks, t_pid, tspec, n=n - 1, impl=impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("full", [False, True], ids=["half", "full"])
def test_k_cap_overflow_raises(impl, full):
    _, _, _, t_masks, t_pid, tspec, _ = _artifacts("mc4_cap32")
    with pytest.raises(ValueError, match="k_cap=4 < max half count"):
        tdec.masks_to_padded(t_masks, t_pid, tspec, k_cap=4, impl=impl,
                             full=full)


@pytest.mark.parametrize("impl", IMPLS)
def test_empty_slot_raises(impl):
    _, _, _, t_masks, t_pid, tspec, _ = _artifacts("mc3_cap48")
    bad = torch.full_like(t_pid, -1)
    with pytest.raises(ValueError, match="empty slot"):
        tdec.decode_pairs(t_masks, bad, tspec, impl=impl)
    with pytest.raises(ValueError, match="empty slot"):
        tdec.masks_to_padded(t_masks, bad, tspec, n=CASES["mc3_cap48"][0],
                             impl=impl)


@pytest.mark.parametrize("impl", IMPLS)
def test_empty_artifact(impl):
    _, _, _, t_masks, t_pid, tspec, _ = _artifacts("mc4_cap32")
    i, j = tdec.decode_pairs(torch.zeros_like(t_masks), t_pid, tspec,
                             impl=impl)
    assert i.size == 0 and j.size == 0 and i.dtype == np.int32
    idx, cnt = tdec.masks_to_padded(torch.zeros_like(t_masks), t_pid, tspec,
                                    impl=impl)
    assert idx.shape == (CASES["mc4_cap32"][0], 8) and int(cnt.sum()) == 0


def test_native_rejects_wrong_shapes():
    _, _, _, t_masks, t_pid, tspec, _ = _artifacts("mc4_cap32")
    with pytest.raises(ValueError, match="masks shape"):
        native.decode_half(t_masks.numpy()[:4], t_pid.numpy(), tspec.mc,
                           tspec.cap)
    with pytest.raises(ValueError, match="pid shape"):
        native.decode_half(t_masks.numpy(), t_pid.numpy()[:-1], tspec.mc,
                           tspec.cap)


@pytest.mark.parametrize("case", ALL)
def test_lists_convert_round_trip(case):
    j_masks, j_pid, jspec, t_masks, t_pid, tspec, total = _artifacts(case)
    _, _, ts, _, _ = rebuilt_pair(case)
    counts, _ = tdf.dense_lists_half(ts.pos, tspec, RS)
    c2, m2 = convert.lists_from_numpy(*convert.lists_to_numpy(counts,
                                                              t_masks),
                                      device="cpu")
    assert torch.equal(c2, counts) and torch.equal(m2, t_masks)
    # JAX masks carried over decode to the same pairs through the port
    _, jm = convert.lists_from_numpy(counts.numpy(), j_masks, device="cpu")
    assert torch.equal(jm, t_masks)
