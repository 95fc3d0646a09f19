"""Kinematic-tree metadata for mocap skeletons.

Equivalent in capability to the reference ``common/skeleton.py:6-87``
(parents/children/left-right bookkeeping and static-joint removal that maps
the raw 32-joint Human3.6M tree to the 17 moving joints), re-implemented as
a small immutable-ish numpy helper.

Counterpart of ``diffpose_tpu/skeleton.py`` (this package keeps its own copy).
"""

from __future__ import annotations

import numpy as np


class Skeleton:
    def __init__(self, parents, joints_left=None, joints_right=None, joints_group=None):
        if joints_left is not None and joints_right is not None:
            assert len(joints_left) == len(joints_right)
        self._parents = np.array(parents, dtype=np.int64)
        self._joints_left = list(joints_left) if joints_left is not None else None
        self._joints_right = list(joints_right) if joints_right is not None else None
        self._joints_group = joints_group
        self._compute_metadata()

    def num_joints(self) -> int:
        return len(self._parents)

    def parents(self) -> np.ndarray:
        return self._parents

    def has_children(self) -> np.ndarray:
        return self._has_children

    def children(self):
        return self._children

    def joints_left(self):
        return self._joints_left

    def joints_right(self):
        return self._joints_right

    def joints_group(self):
        return self._joints_group

    def edges(self) -> tuple[tuple[int, int], ...]:
        """(parent, child) pairs for all non-root joints — the graph edge list."""
        return tuple(
            (int(p), int(c)) for c, p in enumerate(self._parents) if p >= 0
        )

    def remove_joints(self, joints_to_remove):
        """Drop joints, re-parenting children past removed ancestors.

        Returns the indices of the surviving joints (in the original
        numbering), matching the reference semantics
        (``common/skeleton.py:27-64``).
        """
        remove = set(int(j) for j in joints_to_remove)
        valid = [j for j in range(len(self._parents)) if j not in remove]

        parents = self._parents.copy()
        for i in range(len(parents)):
            while parents[i] in remove:
                parents[i] = parents[parents[i]]

        # Offsets: how many removed joints precede each original index.
        offsets = np.zeros(len(parents), dtype=np.int64)
        removed_so_far = 0
        for i in range(len(parents)):
            if i in remove:
                removed_so_far += 1
            offsets[i] = removed_so_far

        new_parents = []
        for i, p in enumerate(parents):
            if i in remove:
                continue
            new_parents.append(p - offsets[p] if p >= 0 else -1)
        self._parents = np.array(new_parents, dtype=np.int64)

        def _remap(joints):
            if joints is None:
                return None
            return [int(j - offsets[j]) for j in joints if j in set(valid)]

        self._joints_left = _remap(self._joints_left)
        self._joints_right = _remap(self._joints_right)
        self._compute_metadata()
        return valid

    def _compute_metadata(self):
        n = len(self._parents)
        self._has_children = np.zeros(n, dtype=bool)
        self._children = [[] for _ in range(n)]
        for child, parent in enumerate(self._parents):
            if parent >= 0:
                self._has_children[parent] = True
                self._children[parent].append(child)
