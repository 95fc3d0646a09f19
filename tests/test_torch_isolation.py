"""The port stands alone: no JAX, no diffpose_tpu; no silent CPU fallback."""

import ast
from pathlib import Path

import pytest
import torch

from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import IGCN, GCNDiff, GCNPose
from diffpose_tpu_torch.models.igcn import bn_state
from diffpose_tpu_torch.ops.fused_denoiser import (
    fused_backbone,
    fused_denoiser,
    fused_lifter,
    prepare_weights,
    timestep_projections,
)
from diffpose_tpu_torch.ops.fused_igcn import make_igcn_fn
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


def test_third_party_imports_are_torch_numpy_yaml_and_a_lazy_matplotlib():
    import sys

    # PIL: utils/visualization.py's JPEG frames, inside functions as matplotlib
    allowed = {"torch", "numpy", "yaml", "matplotlib", "PIL", "diffpose_tpu_torch", "__future__"}
    files = sorted((ROOT / "diffpose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for name in _imports(f):
            top = name.split(".")[0]
            assert top in allowed or top in sys.stdlib_module_names, \
                f"{f.relative_to(ROOT)} imports {name}"
        # matplotlib and PIL (and triton, where a kernel takes that route) only inside functions
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not any(n.split(".")[0] in ("matplotlib", "PIL", "triton") for n in names), \
                    f"{f.relative_to(ROOT)} imports {names} at module level"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_fn(BASIS, seq=(0, 12), betas=BETAS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_weights(GCNPose(BASIS, **CFG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_igcn_fn(IGCN(BASIS, **CFG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_weights(IGCN(BASIS, **CFG))          # fused_backbone's weights


def test_cpu_calls_launch_nothing():
    torch.manual_seed(0)
    wp = prepare_weights(GCNPose(BASIS, **CFG).eval(), device="cpu")
    wd = prepare_weights(GCNDiff(BASIS, **CFG).eval(), device="cpu")
    igcn = IGCN(BASIS, **CFG, max_iterations=3, min_iterations=2).eval()
    wi = prepare_weights(igcn, device="cpu")
    fused_lifter.launches = fused_denoiser.launches = fused_backbone.launches = 0
    x2d = torch.randn(3, 17, 2)
    with torch.no_grad():
        fused_lifter(wp, x2d)
        fused_denoiser(wd, torch.randn(3, 17, 5), torch.zeros(3))
        out = make_eval_fn(BASIS, seq=(0, 12), betas=BETAS, test_times=2, device="cpu")(wp, wd, x2d)
        t = torch.full((3,), 12.0)
        z = fused_backbone(wi, torch.randn(3, 17, CFG["hid_dim"]), timestep_projections(wi, t))
        solved, aux = make_igcn_fn(igcn, device="cpu")(wi, bn_state(igcn), torch.randn(3, 17, 5), t)
    assert out.shape == (3, 17, 3) and bool(torch.isfinite(out).all())
    assert z.shape == (3, 17, CFG["hid_dim"]) and solved.shape == (3, 17, 5)
    assert aux["iterations"] >= 2
    assert (fused_lifter.launches, fused_denoiser.launches, fused_backbone.launches) == (0, 0, 0)
