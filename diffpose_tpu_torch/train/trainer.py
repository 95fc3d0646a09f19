"""The frame-based DiffPose runner: orchestration of train/eval lifecycles.

Capability parity with the reference ``Diffpose`` runner
(``runners/diffpose_frame.py``): builds denoiser + lifter over the 17-joint
H3.6M graph, trains with the GMM forward process + EMA + staircase LR and
evaluates after every epoch, reporting the per-action P1/P2 table.
Counterpart of ``diffpose_tpu/train/trainer.py``: the same constructor
keywords and methods, plus ``device``.

On the card the denoiser's training forward and backward
(``train_impl="fused"``) and the eval forwards (``denoiser_impl="fused"``)
are hand-written CUDA kernels; losses stay on the device and are read once
an epoch; checkpoints are ``torch.save`` files with full resume.  What has
no counterpart in this package raises.

``mesh`` (a ``DeviceMesh`` from ``parallel.make_mesh``, this process one of
its ranks): the train loader is keyed by the rank's ``data`` coordinate and
the steps are ``parallel/sharding.py``'s; each eval batch is split over
``data`` (and its hypotheses over ``hypothesis``) and the per-sample errors
gathered before they are accumulated; only rank 0 writes logs, ``log.tsv``
and checkpoints, and every rank loads on resume.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diffpose_tpu_torch import native
from diffpose_tpu_torch.config import Config
from diffpose_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from diffpose_tpu_torch.data.pipeline import FlatDataset
from diffpose_tpu_torch.diffusion import get_beta_schedule, make_skip_sequence
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.metrics import ActionErrorAccumulator, AverageMeter
from diffpose_tpu_torch.models import GCNDiff, GCNPose
from diffpose_tpu_torch.models.convert import load_torch_states
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.ops.fused_denoiser import resolve_device
from diffpose_tpu_torch.ops.tf32 import PARITY_TIER, check_tier
from diffpose_tpu_torch.parallel.mesh import barrier, is_main_rank, mesh_axis
from diffpose_tpu_torch.parallel.sharding import (
    gather_rows,
    make_sharded_eval_step,
    make_sharded_train_step,
    make_sharded_train_sweep_step,
    shard_batch,
)
from diffpose_tpu_torch.train.checkpoint import Checkpointer
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import make_eval_step, make_train_step, make_train_sweep_step
from diffpose_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

TRAIN_IMPLS = ("module", "plain", "fused")
DENOISER_IMPLS = ("module", "fused")
DROPOUT_IMPLS = ("masks", "prng")
# The JAX package's name of its parity (f32) kernel grade: the CUDA kernels'
# 3xTF32 tensor-core products (f32 FMA on row 4's narrow paths) are that grade.
F32_KERNEL_GRADE = PARITY_TIER
# --matmul_precision: the grade of the torch operations around the kernels.
MATMUL_PRECISIONS = ("float32", "BF16_BF16_F32_X3", "default")


def check_precisions(kernel_precision: str, matmul_precisions):
    """The runners' checks of ``--kernel_precision`` and ``--matmul_precision``:
    every value the JAX runners take."""
    check_tier(kernel_precision)
    for value in matmul_precisions:
        if value not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul precision must be one of {MATMUL_PRECISIONS}, got {value!r}")


def warn_default_tier(train_tier: str):
    """The JAX runner's warning for the default tier on the train kernels
    (``diffpose_tpu/train/trainer.py:307-311``), given the tier the train
    stack runs at (None: no train stack)."""
    if train_tier == "default":
        logger.warning("--kernel_precision default on the TRAIN kernels: single-pass (1xTF32) "
                       "products' gradients are not parity-grade (use bf16x3 for "
                       "reference-accuracy training)")


@contextlib.contextmanager
def matmul_grade(precision: str, device: torch.device):
    """``--matmul_precision`` on ``device``'s torch matrix products and
    convolutions for the block: ``float32`` TF32 off; ``default`` TF32 on,
    the card's single pass, as JAX's ``default`` is on a GPU;
    ``BF16_BF16_F32_X3`` at the f32 grade (PyTorch has no three-pass split of
    an f32 product).  The flags are process-global: each runner sets them
    around its own train and eval and restores them after."""
    if device.type != "cuda":
        yield
        return
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def under_matmul_grade(kind: str):
    """A runner method run under ``matmul_grade(self.<kind>_matmul_precision)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(self, *args, **kwargs):
            with matmul_grade(getattr(self, f"{kind}_matmul_precision"), self.device):
                return fn(self, *args, **kwargs)
        return wrapped
    return deco


class DiffposeRunner:
    def __init__(
        self,
        config: Config,
        *,
        seed: int = 19960903,
        skip_type: str = "uniform",
        eta: float = 0.0,
        mesh=None,
        log_dir: Optional[str] = None,
        use_ema_eval: bool = False,
        reference_compat: bool = True,
        downsample: int = 1,
        action_filter=None,
        eval_sweep: int = 1,
        train_sweep: int = 1,
        denoiser_impl: str = "module",  # "module" | "fused"
        train_impl: str = "module",     # "module" | "plain" | "fused"
        dropout_impl: str = "masks",    # "masks" | "prng" (fused and plain train)
        eval_matmul_precision: str = "float32",
        train_matmul_precision: str = "float32",
        exec_cache: bool = False,
        kernel_precision: str = F32_KERNEL_GRADE,
        device="cuda",
    ):
        from torch.distributed.device_mesh import DeviceMesh

        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(diffpose_tpu_torch.parallel.make_mesh), got {type(mesh).__name__}")
        if denoiser_impl in ("pallas_st", "pallas_full", "fused_st", "fused_full"):
            raise ValueError(
                f"--denoiser_impl {denoiser_impl} belongs to the video family "
                "(diffpose_tpu_torch.cli.main_video); the frame family's whole-network kernel "
                "is --denoiser_impl fused")
        if denoiser_impl not in DENOISER_IMPLS:
            raise ValueError(f"denoiser_impl must be one of {DENOISER_IMPLS}, got {denoiser_impl!r}")
        if train_impl not in TRAIN_IMPLS:
            raise ValueError(f"train_impl must be one of {TRAIN_IMPLS}, got {train_impl!r}")
        if dropout_impl not in DROPOUT_IMPLS:
            raise ValueError(f"dropout_impl must be one of {DROPOUT_IMPLS}, got {dropout_impl!r}")
        check_precisions(kernel_precision, (eval_matmul_precision, train_matmul_precision))
        self.config = config
        self.seed = seed
        self.skip_type = skip_type
        self.eta = eta
        self.mesh = mesh
        # this rank's place on the mesh's axes (trivial without a mesh)
        self._data = mesh_axis(mesh, "data")
        self._hyp = mesh_axis(mesh, "hypothesis")
        self.log_dir = log_dir
        self.use_ema_eval = use_ema_eval
        self.reference_compat = reference_compat
        self.downsample = downsample
        self.action_filter = action_filter
        # >1: this many eval batches between two reads of their errors on the
        # host; results are identical.
        self.eval_sweep = eval_sweep
        # >1: device-resident-data training: the data set lies on the device,
        # the host sends one [train_sweep, B] index array per call.
        self.train_sweep = train_sweep
        self.denoiser_impl = denoiser_impl
        self.train_impl = train_impl
        # dropout of the fused and plain train steps: "masks" (explicit uint8
        # masks drawn from the step's generator) or "prng" (one seed a step,
        # the kernels draw the masks; the same bits on the CPU)
        self.dropout_impl = dropout_impl
        self.eval_matmul_precision = eval_matmul_precision
        self.train_matmul_precision = train_matmul_precision
        self.exec_cache = exec_cache
        if exec_cache:
            logger.info("exec_cache: nothing is compiled per program here; the CUDA kernels' "
                        "build cache under build/ plays its part")
        self.kernel_precision = kernel_precision
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is over {mesh.device_type!r} ranks, the runner's device "
                             f"is {self.device}")

        d = config.diffusion
        self.betas = get_beta_schedule(
            d.beta_schedule,
            beta_start=d.beta_start,
            beta_end=d.beta_end,
            num_diffusion_timesteps=d.num_diffusion_timesteps,
        )
        self.basis = cheb_basis_from_edges(config.model.n_pts, H36M_EDGES, order=2)
        # One generator for parameter inits (CPU) and one for the steps' draws.
        self._init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.model_diff: Optional[GCNDiff] = None
        self.model_pose: Optional[GCNPose] = None
        self.state: Optional[TrainState] = None
        self.pose_params: Optional[GCNPose] = None   # the lifter under evaluation (a module)
        self.train_data: Optional[FlatDataset] = None
        self.test_data: Optional[FlatDataset] = None
        self.checkpointer: Optional[Checkpointer] = None
        if log_dir is not None:
            self.checkpointer = Checkpointer(log_dir)

        # perf tracking (reference --track_metrics equivalent)
        self.inference_times: List[float] = []
        self.eval_frames: int = 0
        self.train_seconds: List[float] = []     # per epoch, the train loop alone

        # Eval step cache: built ONCE per runner lifecycle and reused by every
        # evaluate() call; the weights flow in through state / pose_params.
        # `_eval_builds` counts constructions so tests can assert the second
        # evaluate() builds nothing.
        self._eval_cache: Dict[object, object] = {}
        self._eval_builds: int = 0
        self._native_logged = False

    # ------------------------------------------------------------------
    # Model construction (reference create_diffusion_model / create_pose_model)
    # ------------------------------------------------------------------

    def _init_module(self, cls, coords_in: int, coords_out: int, model_path: Optional[str],
                     what: str, **extra):
        m = self.config.model
        # nn.init draws from torch's default generator: seed it from the
        # runner's stream so that equal seeds give equal weights.
        init_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._init_generator))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(init_seed)
            model = cls(self.basis, hid_dim=m.hid_dim, coords_in=coords_in,
                        coords_out=coords_out, num_layers=m.num_layer, num_heads=m.n_head,
                        dropout_rate=m.dropout, n_pts=m.n_pts, **extra)
        if model_path:
            logger.info("initialize %s model from %s", what, model_path)
            if not model_path.endswith(".pth"):
                raise ValueError(f"{what} model path {model_path!r}: only reference .pth "
                                 "checkpoints load here")
            model.load_state_dict(load_torch_states(model_path)[0], strict=True)
        return model.to(self.device)

    def create_diffusion_model(self, model_path: Optional[str] = None):
        m = self.config.model
        self.model_diff = self._init_module(GCNDiff, m.coords_dim[0], m.coords_dim[1], model_path,
                                            "diffusion")
        return self.model_diff

    def create_pose_model(self, model_path: Optional[str] = None):
        self.model_pose = self._init_module(GCNPose, 2, 3, model_path, "pose").eval()
        self.pose_params = self.model_pose
        return self.model_pose

    # ------------------------------------------------------------------
    # Data
    # ------------------------------------------------------------------

    def prepare_data(self):
        """Load the real H3.6M npz pair configured in ``config.data``."""
        from diffpose_tpu_torch.data.pipeline import prepare_h36m

        d = self.config.data
        if d.dataset != "human36m":
            raise KeyError("Invalid dataset")
        # Note: the train 2D source is dataset_path_train_2d, the test 2D
        # source is dataset_path_test_2d (e.g. GT-trained, CPN-tested).
        train, test = prepare_h36m(
            d.dataset_path,
            d.dataset_path_train_2d,
            d.dataset_path_test_2d,
            action_filter=self.action_filter,
            stride=self.downsample,
        )
        self.set_data(train, test)

    def set_data(self, train: Optional[FlatDataset], test: Optional[FlatDataset]):
        self.train_data = train
        self.test_data = test
        if train is not None:
            logger.info("training dataset: %d frames", len(train))
        if test is not None:
            logger.info("testing dataset: %d frames", len(test))

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _make_loader(self, data: FlatDataset, shuffle: bool, keyed: bool = True) -> BatchLoader:
        """The batches of ``data``; ``keyed``: this rank's slice of each (its
        data coordinate's), else the global batches."""
        if not self._native_logged:
            self._native_logged = True
            logger.info("batch gather: %s", "native library (native/gather_pack.cc)"
                        if native.available() else "numpy (no native library)")
        parts = (self._data.size, self._data.index) if keyed else (1, 0)
        return BatchLoader(data, batch_size=self.config.training.batch_size, shuffle=shuffle,
                           seed=self.seed, process_count=parts[0], process_index=parts[1])

    def _optimizer(self, steps_per_epoch: int):
        """The state's own optimizer, where a state with one exists, else a new one."""
        if self.state is not None and self.state.optimizer is not None:
            return self.state.optimizer
        o = self.config.optim
        return make_optimizer(
            self.model_diff.parameters(),
            optimizer=o.optimizer,
            lr=o.lr,
            lr_gamma=o.lr_gamma,
            decay_epochs=o.decay,
            steps_per_epoch=steps_per_epoch,
            grad_clip=o.grad_clip,
            eps=o.eps,
        )

    def _build_train_step(self, steps_per_epoch: int):
        """The optimizer (the state's own, where a state with one exists) and
        the train step over it."""
        optimizer = self._optimizer(steps_per_epoch)
        ema_mu = self.config.model.ema_rate if self.config.model.ema else None
        dropout = self.dropout_impl if self.train_impl != "module" else "masks"
        kwargs = dict(impl=self.train_impl, ema_mu=ema_mu, device=self.device, dropout=dropout,
                      tier=self.kernel_precision)
        if self.mesh is not None:
            step_fn = make_sharded_train_step(self.model_diff, optimizer, self.betas, self.mesh,
                                              **kwargs)
        else:
            step_fn = make_train_step(self.model_diff, optimizer, self.betas, **kwargs)
        return optimizer, step_fn

    def train_tier(self) -> Optional[str]:
        """The tier the train kernels (or their plain stack) run at, or None
        where the train step runs no such stack (``--train_impl module``)."""
        return self.kernel_precision if self.train_impl in ("fused", "plain") else None

    def _supports_train_sweep(self) -> bool:
        """Whether ``--train_sweep`` can replace this runner's train step."""
        return True

    def _device_train_data(self) -> dict:
        """Stage the whole train set on the device."""
        return {
            "poses_3d": torch.as_tensor(self.train_data.poses_3d, device=self.device),
            "poses_2d_gmm": torch.as_tensor(self.train_data.poses_2d_gmm, device=self.device),
        }

    def _build_sweep_fn(self, optimizer, n: int, base_step):
        """The ``n``-step device-resident sweep call over the runner's step;
        over a mesh it takes the global index array and each rank its columns."""
        if self.mesh is not None:
            return make_sharded_train_sweep_step(self.model_diff, optimizer, self.betas,
                                                 self.mesh, sweep=n, base_step=base_step)
        return make_train_sweep_step(self.model_diff, optimizer, self.betas, sweep=n,
                                     base_step=base_step)

    def init_state(self, optimizer) -> TrainState:
        ema = ema_register(self.model_diff) if self.config.model.ema else None
        return TrainState.create(self.model_diff, optimizer, ema_params=ema)

    @under_matmul_grade("train")
    def train(self, resume: bool = False) -> Dict[str, list]:
        assert self.model_diff is not None and self.train_data is not None
        warn_default_tier(self.train_tier())
        loader = self._make_loader(self.train_data, shuffle=True)
        steps_per_epoch = len(loader)
        optimizer, step_fn = self._build_train_step(steps_per_epoch)

        if self.state is None or self.state.optimizer is not optimizer:
            self.state = self.init_state(optimizer)
        if resume and self.checkpointer is not None and self.checkpointer.latest_step() is not None:
            self.state, restored_pose = self.checkpointer.restore(
                self.state, template_pose_params=self.model_pose
            )
            if restored_pose is not None:
                self.pose_params = restored_pose
            logger.info("resumed from step %d (epoch %d)", int(self.state.step), int(self.state.epoch))

        history = {"loss": [], "p1": [], "p2": []}
        best_p1, best_epoch = float("inf"), -1
        start_epoch = int(self.state.epoch)

        # TSV training curve (reference common/log.py format)
        tsv = None
        if self.log_dir is not None and is_main_rank():
            from diffpose_tpu_torch.utils.tsv_logger import Logger as TsvLogger

            path = os.path.join(self.log_dir, "log.tsv")
            tsv = TsvLogger(path, title=os.path.basename(self.log_dir),
                            resume=resume and os.path.exists(path))
            if not tsv.names:
                tsv.set_names(
                    ["Epoch", "LR", "Train Loss", "Test MPJPE", "Test P-MPJPE"])

        # Device-resident-data sweep path: the whole train set goes to the
        # device once; each call carries only a [sweep, B] index array.
        use_sweep = self.train_sweep > 1 and self._supports_train_sweep()
        if use_sweep:
            # the global index arrays: a sharded sweep takes its rank's columns itself
            index_loader = self._make_loader(self.train_data, shuffle=True, keyed=False)
            data_dev = self._device_train_data()
            sweep_fn = self._build_sweep_fn(optimizer, self.train_sweep, step_fn)
            tail = steps_per_epoch % self.train_sweep
            tail_fn = self._build_sweep_fn(optimizer, tail, step_fn) if tail else None

        self.train_seconds = []
        for epoch in range(start_epoch, self.config.training.n_epochs):
            t0 = time.time()
            # per-epoch reset of a step's carry (the implicit warm start; the
            # reference's reset_history, implicit_pose.py:319-320)
            for fn in (step_fn, *((sweep_fn, tail_fn) if use_sweep else ())):
                getattr(fn, "reset", lambda: None)()
            # Every step's loss counts (the reference averages every step,
            # runners/diffpose_frame.py:233), but the device scalars are
            # collected and read once at epoch end: no per-step sync.
            step_losses = []
            if use_sweep:
                idx_all = list(index_loader.epoch_indices(epoch))
                for start in range(0, len(idx_all), self.train_sweep):
                    group = np.stack(idx_all[start:start + self.train_sweep])
                    fn = sweep_fn if group.shape[0] == self.train_sweep else tail_fn
                    idx = torch.as_tensor(group, dtype=torch.int64, device=self.device)
                    self.state, metrics = fn(self.state, data_dev, idx, self.generator)
                    step_losses.append(metrics["loss"])  # [S] device tensor
            else:
                for batch in prefetch_to_device(loader.epoch(epoch), size=2, device=self.device):
                    self.state, metrics = step_fn(self.state, batch, self.generator)
                    step_losses.append(metrics["loss"].reshape(1))
            self.state.epoch = epoch + 1
            all_losses = torch.cat(step_losses)
            epoch_loss = AverageMeter()
            epoch_loss.update(float(all_losses.mean()), int(all_losses.shape[0]))  # the one sync
            history["loss"].append(epoch_loss.avg)
            self.train_seconds.append(time.time() - t0)
            logger.info(
                "| Epoch %04d | steps %d | loss %.6f | %.2fs |",
                epoch, steps_per_epoch, epoch_loss.avg, self.train_seconds[-1],
            )

            if self.checkpointer is not None:
                barrier()
                if is_main_rank():
                    self.checkpointer.save(
                        int(self.state.step), self.state, pose_params=self.pose_params
                    )
                barrier()   # no rank reads a checkpoint before it is whole

            p1 = p2 = float("nan")
            if self.test_data is not None:
                p1, p2 = self.evaluate(is_train=True)
                history["p1"].append(p1)
                history["p2"].append(p2)
                if p1 < best_p1:
                    best_p1, best_epoch = p1, epoch
                logger.info(
                    "| Best Epoch: %04d MPJPE: %.2f | Epoch: %04d MPJPE: %.2f PA-MPJPE: %.2f |",
                    best_epoch, best_p1, epoch, p1, p2,
                )
            if tsv is not None:
                o = self.config.optim
                lr = o.lr * (o.lr_gamma ** (epoch // max(o.decay, 1)))
                tsv.append([epoch, lr, epoch_loss.avg, p1, p2])
        if tsv is not None:
            tsv.close()
        return history

    # ------------------------------------------------------------------
    # Evaluation (reference test_hyber)
    # ------------------------------------------------------------------

    def _get_eval_fn(self, seq):
        """The per-batch eval step: built once, reused every epoch."""
        key = ("eval_fn", tuple(seq))
        fn = self._eval_cache.get(key)
        if fn is not None:
            return fn
        self._eval_builds += 1
        t_cfg = self.config.testing
        kwargs = dict(test_times=t_cfg.test_times, eta=self.eta, use_ema=self.use_ema_eval,
                      impl=self.denoiser_impl, device=self.device, tier=self.kernel_precision)
        if self.mesh is not None:
            fn = make_sharded_eval_step(
                self.model_diff, self.model_pose, self.betas, seq, self.mesh,
                hyp_axis="hypothesis" if self._hyp.group is not None else None, **kwargs)
        else:
            fn = make_eval_step(self.model_diff, self.model_pose, self.betas, seq, **kwargs)
        self._eval_cache[key] = fn
        return fn

    def _local_batch(self, batch: dict) -> dict:
        """This rank's slice of a global eval batch (the batch itself without
        a mesh)."""
        return shard_batch(self.mesh, batch) if self.mesh is not None else batch

    def _gathered(self, *per_sample: torch.Tensor):
        """Every data rank's per-sample values of one batch, in the global
        batch's order, as host arrays."""
        return tuple(gather_rows(v, self._data).cpu().numpy() for v in per_sample)

    @under_matmul_grade("eval")
    def evaluate(self, is_train: bool = False, state: Optional[TrainState] = None) -> Tuple[float, float]:
        assert self.model_diff is not None and self.model_pose is not None
        assert self.test_data is not None and self.pose_params is not None
        t_cfg = self.config.testing
        seq = make_skip_sequence(
            self.skip_type, t_cfg.test_timesteps, t_cfg.test_num_diffusion_timesteps
        )
        logger.info("using %d diffusion steps: %s", len(seq), list(seq))

        if state is None:
            if self.state is None:
                # eval-only path: wrap the bare model in a state
                self.state = TrainState.create(self.model_diff, optimizer=None, ema_params=None)
            state = self.state

        was_training = self.model_diff.training
        loader = self._make_loader(self.test_data, shuffle=False, keyed=False)
        acc = ActionErrorAccumulator(
            self.test_data.actions,
            num_joints=self.config.model.n_pts,
            reference_compat=self.reference_compat,
        )
        self.inference_times = []
        eval_fn = self._get_eval_fn(seq)
        with span("runner.prepare"):
            prepared = eval_fn.prepare(state, self.pose_params)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)

        # `eval_sweep` batches go to the device before their errors are read
        # back: one host synchronisation per group (1 = per batch).
        sweep = max(int(self.eval_sweep), 1)
        all_batches = loader.epoch(0)
        group: list = []

        def flush():
            if not group:
                return
            with span("runner.batch"):
                t0 = time.time()
                outs = [eval_fn(state, self.pose_params, self._local_batch(b), self.generator,
                                prepared=prepared) for b in group]
                with span("runner.sync"):
                    sync()
                with span("runner.readback"):
                    results = [self._gathered(p1, p2) for p1, p2, _ in outs]
                self.inference_times.append(time.time() - t0)
                for b, (p1_b, p2_b) in zip(group, results):
                    acc.add(b, p1_b, p2_b)
                group.clear()

        for batch in all_batches:
            group.append(batch)
            if len(group) == sweep:
                flush()
        flush()
        self.model_diff.train(was_training)

        self.eval_frames = acc.frames
        logger.info("MPJPE: %.4f | P-MPJPE: %.4f", acc.p1_meter.avg, acc.p2_meter.avg)
        self.last_error_sum = acc.error_sum  # per-action accumulators (parity checks)
        return acc.summarize(print_table=not is_train)

    # ------------------------------------------------------------------

    def throughput_stats(self) -> Dict[str, float]:
        """frames/s over the last evaluate() call (device-inclusive)."""
        total = sum(self.inference_times)
        return {
            "eval_frames": self.eval_frames,
            "eval_seconds": total,
            "frames_per_second": self.eval_frames / total if total > 0 else 0.0,
        }
