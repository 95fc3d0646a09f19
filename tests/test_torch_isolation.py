"""The port stands alone: no JAX, no diffpose_tpu; no silent CPU fallback."""

import ast
from pathlib import Path

import pytest
import torch

from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import GCNDiff, GCNPose
from diffpose_tpu_torch.ops.fused_denoiser import fused_denoiser, fused_lifter, prepare_weights
from diffpose_tpu_torch.ops.fused_pipeline import make_eval_fn

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffpose_tpu")
CFG = dict(hid_dim=32, num_layers=2, num_heads=4)
BASIS = cheb_basis_from_edges(17, H36M_EDGES)
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "diffpose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"
            assert not name.startswith("."), f"{f.relative_to(ROOT)}: use absolute imports"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_fn(BASIS, seq=(0, 12), betas=BETAS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_weights(GCNPose(BASIS, **CFG))


def test_cpu_calls_launch_nothing():
    torch.manual_seed(0)
    wp = prepare_weights(GCNPose(BASIS, **CFG).eval(), device="cpu")
    wd = prepare_weights(GCNDiff(BASIS, **CFG).eval(), device="cpu")
    fused_lifter.launches = fused_denoiser.launches = 0
    x2d = torch.randn(3, 17, 2)
    with torch.no_grad():
        fused_lifter(wp, x2d)
        fused_denoiser(wd, torch.randn(3, 17, 5), torch.zeros(3))
        out = make_eval_fn(BASIS, seq=(0, 12), betas=BETAS, test_times=2, device="cpu")(wp, wd, x2d)
    assert out.shape == (3, 17, 3) and bool(torch.isfinite(out).all())
    assert (fused_lifter.launches, fused_denoiser.launches) == (0, 0)
