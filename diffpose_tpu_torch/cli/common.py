"""Shared CLI plumbing: logging, log directories, seeding, device choice.

Mirrors the reference main scripts' behavior
(``main_diffpose_frame.py:93-160``): log-dir create/overwrite with ``--ni``
non-interactive consent, dual stream+file logging handlers with de-dup,
config snapshot dump, and global seeding.  Counterpart of
``diffpose_tpu/cli/common.py``: every flag keeps its name and default; the
implementation values ``pallas``, ``pallas_st`` and ``pallas_full`` read as
``fused``, ``fused_st`` and ``fused_full`` (the hand-written CUDA kernels),
and ``--device`` chooses where the run lies.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import shutil
import sys

import numpy as np
import torch

# The JAX package's names for its fused implementations, as this one reads them.
_IMPL_ALIASES = {"pallas": "fused", "pallas_st": "fused_st", "pallas_full": "fused_full"}


def add_common_flags(parser: argparse.ArgumentParser):
    parser.add_argument("--seed", type=int, default=19960903, help="Random seed")
    parser.add_argument("--config", type=str, required=True, help="Path to the config file")
    parser.add_argument("--exp", type=str, default="exp", help="Path for saving running related data.")
    parser.add_argument("--doc", type=str, required=True,
                        help="A string for documentation purpose. Will be the name of the log folder.")
    parser.add_argument("--verbose", type=str, default="info",
                        help="Verbose level: info | debug | warning | critical")
    parser.add_argument("--ni", action="store_true",
                        help="No interaction. Suitable for batch launchers")
    parser.add_argument("--actions", default="*", type=str, metavar="LIST",
                        help="actions to train/test on, separated by comma, or * for all")
    # diffusion process
    parser.add_argument("--skip_type", type=str, default="uniform",
                        help="skip according to (uniform or quad(quadratic))")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="eta used to control the variances of sigma")
    parser.add_argument("--downsample", default=1, type=int, metavar="FACTOR",
                        help="downsample frame rate by factor")
    # pretrained models
    parser.add_argument("--model_diff_path", default=None, type=str,
                        help="path of a pretrained diffusion model (.pth)")
    parser.add_argument("--model_pose_path", default=None, type=str,
                        help="path of a pretrained pose lifter")
    parser.add_argument("--train", action="store_true", help="train or evaluate")
    parser.add_argument("--resume", action="store_true", help="resume from the log dir checkpoint")
    # training hyperparameters (reference semantics: these ALWAYS override
    # the YAML — main_diffpose_frame.py:88-91)
    parser.add_argument("--batch_size", default=None, type=int, metavar="N")
    parser.add_argument("--n_epochs", default=None, type=int, metavar="N",
                        help="override training.n_epochs")
    parser.add_argument("--lr_gamma", default=None, type=float, metavar="N")
    parser.add_argument("--lr", default=None, type=float, metavar="N")
    parser.add_argument("--decay", default=None, type=int, metavar="N")
    # test hyperparameters
    parser.add_argument("--test_times", default=None, type=int, metavar="N")
    parser.add_argument("--test_timesteps", default=None, type=int, metavar="N")
    parser.add_argument("--test_num_diffusion_timesteps", default=None, type=int, metavar="N")
    parser.add_argument("--track_metrics", action="store_true",
                        help="Log computational metrics (time, throughput, iterations)")
    # additions over the reference's flags
    parser.add_argument("--device", default="cuda", type=str,
                        help="where the run lies: cuda (the default) or cpu")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard batches over every rank of the job (a 1-D data mesh): "
                        "launch one process a rank with torchrun (e.g. torchrun "
                        "--nproc_per_node 2 -m diffpose_tpu_torch.cli.main_frame ...); "
                        "nccl over --device cuda (rank r on cuda:LOCAL_RANK), gloo over "
                        "--device cpu; without a launcher, a world of one rank")
    parser.add_argument("--use_ema_eval", action="store_true",
                        help="evaluate the EMA shadow weights instead of the live weights")
    parser.add_argument("--synthetic_frames", default=0, type=int,
                        help="use a synthetic dataset of N frames instead of the npz files (smoke runs)")
    parser.add_argument("--eval_sweep", default=1, type=int, metavar="N",
                        help="eval batches per host synchronisation (identical results)")
    parser.add_argument("--train_sweep", default=1, type=int, metavar="N",
                        help="optimizer steps per call over a device-resident dataset "
                        "(the host sends one index array per call)")
    parser.add_argument("--hypothesis_parallel", default=0, type=int, metavar="H",
                        help="shard test_times hypotheses over a second mesh axis of H ranks: "
                        "a (world // H, H) data x hypothesis grid, launched and backed as "
                        "--data_parallel; the world size must divide by H")
    parser.add_argument("--train_impl", default="module",
                        choices=("module", "plain", "fused", "pallas"),
                        help="training fwd+bwd implementation: the nn.Module under "
                        "autograd; plain (explicit-mask tensor code under autograd); "
                        "or fused, the hand-written CUDA forward/backward kernel "
                        "pair behind an autograd.Function (pallas reads as fused)")
    parser.add_argument("--dropout_impl", default="masks",
                        choices=("masks", "prng"),
                        help="dropout for --train_impl fused and plain: explicit uint8 "
                        "masks drawn from the step's generator, or prng: one "
                        "seed a step, the masks drawn inside the kernels with "
                        "Philox (no mask in device memory; statistically "
                        "identical; on the CPU the same bits from numpy)")
    parser.add_argument("--matmul_precision", default="float32",
                        choices=("float32", "BF16_BF16_F32_X3", "default"),
                        help="matmul grade of the torch operations around the kernels "
                        "(train and eval), set by each runner around its own train and "
                        "eval: float32 (strict parity, TF32 off); default (TF32 on, the "
                        "card's single pass, as JAX's default on a GPU); "
                        "BF16_BF16_F32_X3 computes at the float32 grade (PyTorch has no "
                        "three-pass split of an f32 product)")
    parser.add_argument("--exec_cache", action="store_true",
                        help="accepted for the JAX package's command lines: the "
                        "kernels' build cache under build/ plays its part")
    parser.add_argument("--kernel_precision", default="bf16x3",
                        choices=("bf16x3", "bf16", "default"),
                        help="kernel matmul grade: bf16x3 names the parity (f32) "
                        "grade, which the CUDA kernels compute as 3xTF32 on the tensor "
                        "cores (rows 1-3, 5-10 and row 4's wide path; row 4's narrow "
                        "paths in f32 FMA).  The eval kernels (rows 1-3, 9-10) also "
                        "run bf16 (one tensor-core pass on bf16 operands, activations "
                        "rounded to bf16 where the TPU kernels cast them) and default "
                        "(one TF32 pass), and so do the train kernels (rows 5-8) and "
                        "their plain stack with --train_impl fused or plain (bf16 there "
                        "rounds the products' operands and, as the TPU kernels do, the "
                        "attention's segment products).  At default the frame and "
                        "implicit families warn when they train on the kernels; the "
                        "video family trains its kernels at the parity grade, as the "
                        "JAX runner does")
    parser.add_argument("--denoiser_impl", default="module",
                        choices=("module", "fused", "pallas", "fused_st", "pallas_st",
                                 "fused_full", "pallas_full"),
                        help="eval forward implementation: the nn.Module, or fused, "
                        "the hand-written whole-network CUDA kernels (pallas reads "
                        "as fused).  The video family also takes pallas_st (read as "
                        "fused_st: temporal blocks on their kernel) and pallas_full "
                        "(fused_full: one kernel a spatio-temporal layer)")
    return parser


def resolve_impl(value: str) -> str:
    """An ``--*_impl`` value in this package's names."""
    return _IMPL_ALIASES.get(value, value)


def setup_experiment(args):
    """Log dir + logging + config; returns the loaded Config.  On a rank
    other than 0 of a process group (a sharded run) nothing is written: no
    log dir, config snapshot or log file, and only warnings reach the
    console."""
    from diffpose_tpu_torch.config import load_config, save_config
    from diffpose_tpu_torch.parallel.mesh import is_main_rank

    args.log_path = os.path.join(args.exp, args.doc)

    overrides = {}
    for k in ("batch_size", "lr", "lr_gamma", "decay"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    config = load_config(args.config, cli_overrides=overrides)
    for k in ("test_times", "test_timesteps", "test_num_diffusion_timesteps"):
        v = getattr(args, k)
        if v is not None:
            setattr(config.testing, k, v)
    if args.n_epochs is not None:
        config.training.n_epochs = args.n_epochs

    main_rank = is_main_rank()   # of a sharded run, rank 0 alone writes the log dir
    if main_rank and args.train and not args.resume:
        if os.path.exists(args.log_path):
            overwrite = args.ni or _ask_overwrite()
            if not overwrite:
                print("Folder exists. Program halted.")
                sys.exit(0)
            shutil.rmtree(args.log_path)
        os.makedirs(args.log_path, exist_ok=True)
        save_config(config, os.path.join(args.log_path, "config.yml"))
    elif main_rank:
        os.makedirs(args.log_path, exist_ok=True)

    level = getattr(logging, args.verbose.upper(), None)
    if not isinstance(level, int):
        raise ValueError(f"level {args.verbose} not supported")
    handlers = [logging.StreamHandler()]
    if main_rank:
        handlers.append(logging.FileHandler(os.path.join(args.log_path, "stdout.txt")))
    formatter = logging.Formatter(
        "%(levelname)s - %(filename)s - %(asctime)s - %(message)s"
    )
    logger = logging.getLogger()
    for h in list(logger.handlers):
        logger.removeHandler(h)
    for h in handlers:
        h.setFormatter(formatter)
        logger.addHandler(h)
    logger.setLevel(level if main_rank else max(level, logging.WARNING))

    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    return config


def _ask_overwrite() -> bool:
    response = input("Folder already exists. Overwrite? (Y/N)")
    return response.upper() == "Y"


@contextlib.contextmanager
def make_mesh_if_requested(args):
    """The ``DeviceMesh`` that ``--data_parallel`` / ``--hypothesis_parallel H``
    ask for (``diffpose_tpu/cli/common.py:182-194``), or None, for the body
    of a ``with``.

    Joins the process group first (``parallel.distributed_init``: the ranks
    of a ``torchrun`` launch, a world of one, or the group the calling
    process is in already): ``--data_parallel`` gives a 1-D data mesh over
    the world, ``--hypothesis_parallel H`` a ``(world // H, H)`` data x
    hypothesis grid.  A world that does not divide by H raises.  A group
    joined here is left again when the ``with`` ends, however it ends."""
    hyp = getattr(args, "hypothesis_parallel", 0)
    if not getattr(args, "data_parallel", False) and not hyp:
        yield None
        return
    import torch.distributed as dist

    from diffpose_tpu_torch.parallel.mesh import distributed_init, distributed_shutdown, make_mesh

    joined = not dist.is_initialized()
    _, world = distributed_init(device=args.device)
    device_type = torch.device(args.device).type
    try:
        if hyp:
            if world % hyp:
                raise ValueError(f"{world} ranks not divisible by hypothesis_parallel={hyp}")
            yield make_mesh((world // hyp, hyp), ("data", "hypothesis"), device_type=device_type)
        else:
            yield make_mesh(device_type=device_type)
    finally:
        if joined:
            distributed_shutdown()


def resolve_action_filter(args):
    return None if args.actions == "*" else args.actions.split(",")
