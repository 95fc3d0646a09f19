"""The Anderson body's kernel wrapper (``ops/fused_anderson.py``) on the CPU:
on CPU tensors it is the plain body (``models/solvers.py:anderson_body_plain``)
bit for bit and counts no launch, and its input checks raise before any
library is loaded.  The kernels themselves run only on the card
(``chip_smoke.py`` phase 39); the rule they compute is held on the CPU in
``tests/test_torch_anderson_ring.py``."""

import pytest
import torch

from diffpose_tpu_torch.models import solvers
from diffpose_tpu_torch.ops import fused_anderson as fa

torch.set_num_threads(1)


def state(seed, d=96, m=5, dtype=torch.float32, it=7):
    """A body's inputs: ``z``, ``f(z)`` and histories whose first
    ``min(it, m)`` ring slots hold distinct rows (the rest zero)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).to(dtype)
    X, F = torch.zeros((m, d), dtype=dtype), torch.zeros((m, d), dtype=dtype)
    filled = min(it, m)
    X[:filled], F[:filled] = r(filled, d), 0.5 * r(filled, d)
    z = r(d // 3, 3)
    return z, z + 0.5 * r(d // 3, 3), X, F


@pytest.mark.parametrize("it, beta, dtype", [(0, 1.0, torch.float32), (3, 0.7, torch.float32),
                                             (7, 1.0, torch.float32), (12, 0.7, torch.float64)])
def test_wrapper_on_cpu_is_the_plain_body(it, beta, dtype):
    z, fz, X, F = state(it, dtype=dtype, it=it)
    want = solvers.anderson_body_plain(z, fz, X, F, it, beta, 0.1)
    before = fa.fused_anderson_body.launches
    got = fa.fused_anderson_body(z, fz, X, F, it, beta, 0.1)
    for a, b in zip(got[:4] + got[4], want[:4] + want[4]):
        assert torch.equal(a, b)
    assert fa.fused_anderson_body.launches == before


@pytest.mark.parametrize("what", ["it_tensor", "it_negative", "shapes_differ", "history_width",
                                  "m_too_large", "float16", "two_dtypes", "history_strided",
                                  "grad"])
def test_kernel_input_checks_raise_before_loading(monkeypatch, what):
    monkeypatch.setattr(fa, "_library", lambda: pytest.fail("the library was loaded"))
    z, fz, X, F = state(2)
    it = 7
    if what == "it_tensor":
        it = torch.tensor(7)
    elif what == "it_negative":
        it = -1
    elif what == "shapes_differ":
        fz = fz[:-1]
    elif what == "history_width":
        X, F = X[:, :-3], F[:, :-3]
    elif what == "m_too_large":
        X, F = torch.zeros(9, z.numel()), torch.zeros(9, z.numel())
    elif what == "float16":
        z, fz, X, F = (t.half() for t in (z, fz, X, F))
    elif what == "two_dtypes":
        fz = fz.double()
    elif what == "history_strided":
        X = torch.zeros(z.numel(), 5).t()
    else:
        z.requires_grad_(True)
    with pytest.raises(ValueError):
        fa._launch(z, fz, X, F, it, 1.0, 0.1)
