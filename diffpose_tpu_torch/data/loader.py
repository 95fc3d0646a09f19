"""Host-side batch iteration with static shapes and multi-host sharding.

Replaces the reference's 32-worker ``torch.utils.data.DataLoader``
(``runners/diffpose_frame.py:170-173``): the heavy per-sample work (GMM
kernel draw) is done on device (:mod:`diffpose_tpu_torch.data.gmm`), so the host
loader is a thin permutation + gather.  Counterpart of
``diffpose_tpu/data/loader.py``: the same batches, ``valid`` masks and
``seeds`` for the same arguments.

* every batch has the same static shape: the trailing partial batch is
  wrap-padded (the reference generator also wraps indices modulo the
  dataset length, ``common/generators.py:26-29``) and carries a ``valid``
  mask so eval can discount padding;
* for multi-host runs each process takes a disjoint contiguous slice of
  the *same* global permutation (seeded identically on all hosts), so the
  global sample order is host-count invariant — required for parity runs.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from diffpose_tpu_torch import native
from diffpose_tpu_torch.data.pipeline import FlatDataset
from diffpose_tpu_torch.utils.profiling import span


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Async host→device prefetch: keep ``size`` batches in flight.

    For a CUDA device each array goes through a pinned host tensor and a
    ``non_blocking=True`` copy, so enqueuing the next batch's transfer
    before the current step runs overlaps the copy with compute.  The
    batches come out as dicts of tensors on ``device``.
    """
    import collections

    device = torch.device(device)
    pin = device.type == "cuda"
    queue = collections.deque()

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(device, non_blocking=True) if pin else t
        return out

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


class BatchLoader:
    def __init__(
        self,
        dataset: FlatDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        process_count: int = 1,
        process_index: int = 0,
    ):
        assert 0 <= process_index < process_count
        assert batch_size % process_count == 0, "global batch must divide across hosts"
        self.dataset = dataset
        self.batch_size = batch_size
        self.per_host_batch = batch_size // process_count
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_count = process_count
        self.process_index = process_index

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """Index-only iteration (device-resident-data training): yields the
        same per-host ``[B]`` dataset indices :meth:`epoch` would gather,
        without assembling the batches on the host."""
        n = len(self.dataset)
        if self.shuffle:
            perm = np.random.default_rng(self.seed + epoch).permutation(n)
        else:
            perm = np.arange(n)
        for b in range(len(self)):
            start = b * self.batch_size
            idx_global = np.arange(start, start + self.batch_size) % n
            idx = perm[idx_global]
            lo = self.process_index * self.per_host_batch
            yield idx[lo:lo + self.per_host_batch].astype(np.int32)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        if self.shuffle:
            perm = np.random.default_rng(self.seed + epoch).permutation(n)
        else:
            perm = np.arange(n)

        num_batches = len(self)
        for b in range(num_batches):
            with span("loader.batch"):      # closed before the yield
                start = b * self.batch_size
                idx_global = np.arange(start, start + self.batch_size)
                valid = idx_global < n
                idx_global = idx_global % n  # wrap-pad the tail
                idx = perm[idx_global]
                # Contiguous per-host slice of the global batch.
                lo = self.process_index * self.per_host_batch
                hi = lo + self.per_host_batch
                sel = idx[lo:hi]
                # Per-sample RNG ids: deterministic in (loader seed, epoch,
                # dataset index) — they make on-device randomness (GMM kernel
                # draw) independent of batch/shard layout.
                seeds = (
                    np.asarray(sel, np.int64) * 2654435761
                    + np.int64(epoch) * 97531
                    + np.int64(self.seed) * 1000003
                ).astype(np.uint32).astype(np.int32)
                # Batch assembly via the native multithreaded multi-array
                # row-gather when the library is available (one parallel region
                # for both big arrays; numpy fancy-indexing fallback).
                p3, p2 = native.gather_rows_multi(
                    [self.dataset.poses_3d, self.dataset.poses_2d_gmm], sel
                )
                batch = {
                    "poses_3d": p3,
                    "poses_2d_gmm": p2,
                    "action_ids": self.dataset.action_ids[sel],
                    "valid": valid[lo:hi],
                    "seeds": seeds,
                }
                # Video window datasets carry no per-sample camera params.
                cam = getattr(self.dataset, "camera_para", None)
                if cam is not None:
                    batch["camera_para"] = cam[sel]
            yield batch
