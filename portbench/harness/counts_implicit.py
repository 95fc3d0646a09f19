"""Operations and bytes of the implicit family's eval, from shapes alone.

Kernel row 3 (``net_forward_kernel<true,false,96,96>``, the bare stack that
every evaluation of the fixed-point map runs) and a batch's model work, in
``counts.py``'s terms: the work the function needs, counted once (a
multiply-add is two operations), each input read once and each output
written once.  Row 3's are frozen copies of ``chip_smoke.py:backbone_flops``
and ``backbone_bytes``, from sizes instead of prepared weights.

The Anderson rule gives the newest history row a weight of zero, so only the
bodies whose history holds copies of one iterate (bodies 0, m, 2m, …) move
``z``, each by the plain step ``z + β·(f(z) − z)``; the others return ``z``
(``reference/implicit.py``).  A solve of ``k`` bodies therefore needs
``⌈k / m⌉`` evaluations of the map and as many plain steps, whatever an
implementation runs besides.
"""

from __future__ import annotations

from portbench.harness import counts
from portbench.harness.counts import Net


def backbone_flops(w: Net, rows: int) -> int:
    """Row 3 at ``rows``: the L layers, without the input and output ChebConvs."""
    return sum(counts.stack_flops(w, rows))


def backbone_bytes(w: Net, rows: int) -> int:
    """Row 3 at ``rows``: the stack's weights once, the sparse Chebyshev terms,
    ``z`` read and the output written (``rows × n × hid`` each), and each
    layer's timestep projection (``rows × hid``) read."""
    act = rows * w.hid * (2 * w.n + w.layers)
    return 4 * counts.stack_weights(w) + counts.term_list_bytes(w) + 4 * act


def moving_bodies(iterations: int, m: int) -> int:
    """The bodies of a solve of ``iterations`` bodies that move ``z``."""
    return -(-iterations // m)


def io_flops(w: Net, rows: int) -> int:
    """The IGCN's input and output ChebConvs at ``rows``."""
    return 2 * rows * (w.n * (w.c_in * 3 * w.hid + w.hid * 3 * w.c_out) + w.nnz * (w.hid + w.c_out))


def eval_batch_flops(den: Net, lifter: Net, batch: int, test_times: int, iterations: int,
                     m: int) -> int:
    """Model operations of one eval batch whose solve ran ``iterations``
    bodies: the lifter on ``batch`` frames; on each of the ``batch ×
    test_times`` rows the timestep MLP, the two ChebConvs, and a stack and a
    plain step (the residual, its scaling and the sum: three operations a
    value) for each body that moves ``z``."""
    rows = batch * test_times
    moving = moving_bodies(iterations, m)
    return (sum(counts.net_flops(lifter, batch)) + rows * counts.timestep_mlp_flops(den.hid, den.layers)
            + io_flops(den, rows)
            + moving * (backbone_flops(den, rows) + 3 * rows * den.n * den.hid))
