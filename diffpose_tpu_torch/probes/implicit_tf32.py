"""How far the train kernels' 3xTF32 arithmetic alone moves the damped 20/10
implicit train step's first-step gradients.

``chip_smoke.py`` phase 14 prints, on more seeds, the worst first-step
gradient error of the fused implicit step (rows 7-8 once per iteration)
against the module step.  This probe takes the same draws (the same seeded
IGCN at the width of ``configs/human36m_ipose.yml``, damped 20/10, B=512,
the same synthetic batch and prng dropout seed) and computes the gradients
five ways:

* ``fused``: the kernel pair (on the card only);
* ``module``: ``IGCN.forward`` in training mode, float32;
* ``plain32``: the kernels' plain twin (``layers_forward`` forward,
  ``stack_bwd_plain`` + ``weight_grads`` backward) in float32;
* ``plain3x``: the same twin with every channel product through
  ``ops/tf32.py:matmul_3xtf32``, the kernels' k-step arithmetic (bit-equal to
  ``mma.sync`` in ``chip_smoke.py`` phase 24);
* ``plain3x_wholek``: the same with ``accumulate="whole_k"``, the design the
  kernels had before their k-step partials (all three passes over the whole
  K into one truncating accumulator).

It prints each pair's worst entry error (``chip_smoke.py:grad_close``: 0
under 1e-5, else relative to the reference's largest entry).  If ``plain3x``
against ``plain32`` comes out as large as ``fused`` against ``module``, the
gap is the arithmetic, amplified by the solve, and not a kernel fault.

``matmul_3xtf32`` works in float64 on every product's terms: exact products
of TF32 operands, sums of truncated terms that float64 holds exactly, and
float32 additions in order, so it gives the same bits on any device; on the
card it takes about a minute a seed, on the host hours.

    python -m diffpose_tpu_torch.probes.implicit_tf32 [--seeds 1 3 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import time

import torch

from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import IGCN
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops.fused_igcn_train import make_igcn_train_fn
from diffpose_tpu_torch.ops.tf32 import matmul_3xtf32
from diffpose_tpu_torch.ops.train_ref import STASH_KEYS, layers_forward
from diffpose_tpu_torch.train.steps import make_draw

BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
BATCH, STEPS, BASE_SEED = 512, 3, 0       # chip_smoke.py IMPLICIT_BATCH, IMPLICIT_STEPS, SEED
GRAD_ABS = 1e-5
CHUNK_ROWS = 2048                        # rows of one 3xTF32 product at a time (float64 terms)


def chunked_3xtf32(accumulate: str = "kstep"):
    """``matmul_3xtf32(a, w, accumulate)`` over ``CHUNK_ROWS`` rows at a time
    (the rows are independent, so the bits are the same)."""
    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        rows = a.reshape(-1, a.shape[-1])
        out = torch.cat([matmul_3xtf32(r, w, accumulate) for r in rows.split(CHUNK_ROWS)])
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return mm


class _PlainStack(torch.autograd.Function):
    """The kernel pair's function in tensor operations, with the kernels'
    split into forward (stashes) and backward (d-stashes, then
    ``weight_grads``), the channel products through ``matmul``."""

    @staticmethod
    def forward(ctx, cfg, masks, matmul, h0, tp, *stack):
        w = dict(cfg, **dict(zip(ft.STACK_KEYS, stack)))
        d5, st = layers_forward(w, h0, tp, masks, return_stashes=True, matmul=matmul)
        ctx.cfg, ctx.masks, ctx.matmul = cfg, masks, matmul
        ctx.save_for_backward(*stack, *[st[k] for k in STASH_KEYS])
        return d5

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dd5):
        saved = ctx.saved_tensors
        w = dict(ctx.cfg, **dict(zip(ft.STACK_KEYS, saved)))
        st = dict(zip(STASH_KEYS, saved[len(ft.STACK_KEYS):]))
        da0, dtp, ds = ft.stack_bwd_plain(w, ctx.masks, st, dd5.contiguous(), matmul=ctx.matmul)
        grads = ft.weight_grads(w, st, ds)
        return (None, None, None, da0, dtp, *[grads[k] for k in ft.STACK_KEYS])


def plain_stack(matmul=None):
    """``stack(w, h0, tp, masks)`` for ``make_igcn_train_fn(stack=...)``."""
    def stack(w, h0, tp, masks):
        cfg = {k: v for k, v in w.items() if k not in ft.STACK_KEYS}
        return _PlainStack.apply(cfg, masks, matmul, h0, tp, *[w[k] for k in ft.STACK_KEYS])
    return stack


def seeded_igcn(basis, dev, gen: torch.Generator) -> IGCN:
    """``chip_smoke.py:seeded_igcn``: the config's widths, the parameters an
    init leaves trivial perturbed, running buffers off their init."""
    model = IGCN(basis)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("A_hat"):
                p.add_(0.1 * torch.rand(p.shape, generator=gen))
            elif name.endswith(("bias", "a_2", "b_2")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        model.batch_norm.running_mean.add_(0.1 * torch.randn(96, generator=gen))
        model.batch_norm.running_var.mul_(0.5 + torch.rand(96, generator=gen))
    return model.to(dev)


def first_step_grads(model: IGCN, draws, how: str) -> dict:
    """The first step's raw gradients of ``how``'s training forward."""
    m = copy.deepcopy(model).train()
    t = draws.t.to(torch.float32)
    if how == "module":
        out, _ = m(draws.x_t, t, masks=draws.masks)
    elif how == "fused":
        out, _, _ = make_igcn_train_fn(m, dropout="prng")(draws.x_t, t, draws.seed)
    else:
        matmul = {"plain32": None, "plain3x": chunked_3xtf32("kstep"),
                  "plain3x_wholek": chunked_3xtf32("whole_k")}[how]
        stack = plain_stack(matmul)
        out, _, _ = make_igcn_train_fn(m, dropout="masks", stack=stack)(draws.x_t, t, draws.masks)
    loss = ((draws.e - out) ** 2).sum(dim=(1, 2)).mean()
    names = [k for k, _ in m.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(m.parameters()))))


def worst(got: dict, want: dict):
    """The worst entry error over the parameters, the key biases apart (their
    gradient is 0 in exact arithmetic): ``(error, name)``."""
    def close(g, r):
        d = float((g - r).abs().max())
        return 0.0 if d < GRAD_ABS else d / (float(r.abs().max()) + 1e-8)
    return max((close(got[k], want[k]), k) for k in got
               if not k.endswith("self_attn.linears.1.bias"))


PAIRS = (("fused", "module"), ("plain3x", "plain32"), ("fused", "plain3x"), ("plain32", "module"),
         ("plain3x_wholek", "plain32"))


def run(seeds=(1, 3, 4), device: str = "cuda") -> dict:
    """Each seed's worst errors for ``PAIRS`` (those that need the kernels
    only on a CUDA device), printed and returned."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    basis = cheb_basis_from_edges(17, H36M_EDGES)
    data = make_synthetic_dataset(num_frames=STEPS * BATCH, seed=BASE_SEED + 2)
    data = {"poses_3d": torch.as_tensor(data.poses_3d, device=dev),
            "poses_2d_gmm": torch.as_tensor(data.poses_2d_gmm, device=dev)}
    batches = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in data.items()} for i in range(STEPS)]
    hows = ("module", "plain32", "plain3x", "plain3x_wholek")
    if dev.type == "cuda":
        hows = ("fused",) + hows
    out = {}
    for s in seeds:
        seed = BASE_SEED + s
        torch.manual_seed(seed)
        model = seeded_igcn(basis, dev, torch.Generator().manual_seed(seed))
        model.solver, model.max_iterations, model.min_iterations = "damped", 20, 10
        draw = make_draw(BETAS, dev, num_layers=model.num_layers, num_heads=model.num_heads,
                         hid_dim=model.hid_dim, dropout="prng", masks_dtype=torch.float32)
        d = draw(batches[s % STEPS], torch.Generator(device=dev).manual_seed(seed))
        grads, secs = {}, {}
        for how in hows:
            t0 = time.perf_counter()
            grads[how] = first_step_grads(model, d, how)
            secs[how] = time.perf_counter() - t0
        out[seed] = {f"{a} vs {b}": worst(grads[a], grads[b]) for a, b in PAIRS
                     if a in grads and b in grads}
        print(f"damped 20/10, B={BATCH}, seed {seed} ({dev.type}; seconds "
              + ", ".join(f"{h} {v:.1f}" for h, v in secs.items()) + "): worst first-step "
              "gradient rel err " + "; ".join(f"{k} {v[0]:.2e} ({v[1]})" for k, v in out[seed].items()),
              flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 3, 4],
                        help="chip_smoke.py MARGIN_SEEDS to run")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(tuple(args.seeds), args.device)


if __name__ == "__main__":
    main()
