"""Port BatchLoader / prefetch_to_device / native binding vs the JAX package's."""

import numpy as np
import pytest
import torch

from diffpose_tpu import native as jnative
from diffpose_tpu.data.loader import BatchLoader as JBatchLoader
from diffpose_tpu_torch import native
from diffpose_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)

DATA = make_synthetic_dataset(num_frames=70, seed=4)


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "in_order"])
@pytest.mark.parametrize("hosts,index", [(1, 0), (2, 0), (2, 1)], ids=["1host", "host0of2", "host1of2"])
def test_batches_valid_and_seeds_equal_jax(shuffle, hosts, index):
    kw = dict(batch_size=32, shuffle=shuffle, seed=19960903, process_count=hosts,
              process_index=index)
    ours, theirs = BatchLoader(DATA, **kw), JBatchLoader(DATA, **kw)
    assert len(ours) == len(theirs) == 3
    for epoch in (0, 2):
        a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert a[-1]["valid"].sum() * hosts <= 70 - 64 + 32 // hosts * (hosts - 1)
        for i, j in zip(ours.epoch_indices(epoch), theirs.epoch_indices(epoch)):
            np.testing.assert_array_equal(i, j)


def test_seeds_wrap_like_the_int64_formula():
    big = BatchLoader(DATA, batch_size=35, shuffle=True, seed=2 ** 31 - 1)
    batch = next(iter(big.epoch(3)))
    assert batch["seeds"].dtype == np.int32 and len(set(batch["seeds"].tolist())) == 35
    assert batch["seeds"].min() < 0 < batch["seeds"].max()


def test_drop_last_and_host_split_checks():
    assert len(BatchLoader(DATA, batch_size=32, drop_last=True)) == 2
    with pytest.raises(AssertionError):
        BatchLoader(DATA, batch_size=33, process_count=2)


def test_prefetch_to_device_keeps_batches_and_order():
    loader = BatchLoader(DATA, batch_size=32, shuffle=True, seed=1)
    plain = list(loader.epoch(0))
    for size in (1, 2, 5):
        fetched = list(prefetch_to_device(loader.epoch(0), size=size, device="cpu"))
        assert len(fetched) == len(plain)
        for a, b in zip(plain, fetched):
            assert set(a) == set(b)
            for k in a:
                assert isinstance(b[k], torch.Tensor) and b[k].device.type == "cpu"
                np.testing.assert_array_equal(b[k].numpy(), a[k])


def test_native_binding_equals_numpy_and_the_jax_packages(rng):
    src = rng.normal(size=(50, 17, 5, 5)).astype(np.float32)
    ids = rng.integers(0, 50, size=23)
    np.testing.assert_array_equal(native.gather_rows(src, ids), src[ids])
    a, b = native.gather_rows_multi([src, DATA.poses_3d[:50]], ids)
    np.testing.assert_array_equal(a, src[ids])
    np.testing.assert_array_equal(b, DATA.poses_3d[:50][ids])
    gmm = np.abs(rng.normal(size=(6, 17, 5, 5))).astype(np.float32)
    gmm[..., 0] /= gmm[..., 0].sum(-1, keepdims=True)
    u = rng.random(size=(6, 17)).astype(np.float32)
    for got, want in zip(native.gmm_select(gmm, u), jnative.gmm_select(gmm, u)):
        np.testing.assert_array_equal(got, want)
    assert native.available() == jnative.available()
