"""The video runner: spatio-temporal diffusion over frame windows.

Counterpart of ``diffpose_tpu/train/video_runner.py`` (the reference
delegates the family to an external project, ``README.md:92-93``): model
lifecycle, GMM forward-process training with EMA and the staircase, a
windowed DDIM evaluation after every epoch with the per-action P1/P2 table,
step-numbered ``torch.save`` checkpoints with resume.

``train_impl="fused"`` runs every spatial block's forward and backward
through the train kernel pair (``ops/fused_video_train.py``);
``denoiser_impl`` picks the eval forward: ``"fused"`` (spatial blocks on
kernel row 3, temporal blocks as torch operations), ``"fused_st"`` (row 3
and row 10), ``"fused_full"`` (one launch of row 9 a layer), or
``"module"``.  Where the config has a ``mixste`` section the denoiser is
the MixSTE transformer (``models/mixste.py``), which runs on the module path
alone (the kernels are ``SpatioTemporalDiff``'s) and on one device.

``mesh`` (a ``DeviceMesh`` from ``parallel.make_mesh``, this process one of
its ranks): windows shard over ``data_axis`` and each window's frames over
``cp_axis`` (``F / size`` frames a rank; the model gathers the keys and
values), as ``diffpose_tpu/train/video_runner.py`` resolves them: an axis
the mesh does not have is left out.  The train loader is keyed by the data
coordinate and each rank takes its frames; each eval batch is split over
both axes and the per-frame errors gathered before they are accumulated;
only rank 0 writes logs and checkpoints, and every rank loads on resume.
Under a context axis the fused train step and the whole-window eval
forwards (``fused_st``, ``fused_full``) are refused (the JAX runner falls
back to the module step with a warning; this one raises).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import torch

from diffpose_tpu_torch.config import Config, VideoConfig
from diffpose_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from diffpose_tpu_torch.data.video import VideoDataset
from diffpose_tpu_torch.diffusion import get_beta_schedule, make_skip_sequence
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.metrics import ActionErrorAccumulator, AverageMeter
from diffpose_tpu_torch.models.convert import load_torch_states
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.models.mixste import MixSTE
from diffpose_tpu_torch.models.video import SpatioTemporalDiff
from diffpose_tpu_torch.ops.fused_denoiser import resolve_device
from diffpose_tpu_torch.ops.fused_video import make_video_denoiser_fn
from diffpose_tpu_torch.ops.fused_video_full import make_video_full_fn
from diffpose_tpu_torch.parallel.mesh import barrier, is_main_rank, mesh_axis
from diffpose_tpu_torch.parallel.sharding import (
    gather_windows,
    make_sharded_video_eval_step,
    make_sharded_video_train_step,
    shard_windows,
)
from diffpose_tpu_torch.train.checkpoint import Checkpointer
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.trainer import (
    DROPOUT_IMPLS,
    F32_KERNEL_GRADE,
    TRAIN_IMPLS,
    check_precisions,
    under_matmul_grade,
    warn_default_tier,
)
from diffpose_tpu_torch.train.video_steps import make_video_eval_step, make_video_train_step
from diffpose_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

VIDEO_DENOISER_IMPLS = ("module", "fused", "fused_st", "fused_full")


def video_denoise_override(model, impl: str, tier: str = F32_KERNEL_GRADE):
    """The fused eval forward that ``impl`` (one of :data:`VIDEO_DENOISER_IMPLS`)
    names at kernel tier ``tier``, for ``make_video_eval_step``'s
    ``denoise_override``; None for the module."""
    if impl == "fused_full":
        return make_video_full_fn(model, tier=tier)
    if impl in ("fused", "fused_st"):
        return make_video_denoiser_fn(model, tier=tier,
                                      temporal_impl="kernel" if impl == "fused_st" else "torch")
    return None


class VideoRunner:
    def __init__(
        self,
        config: Config,
        *,
        seed: int = 19960903,
        skip_type: str = "uniform",
        eta: float = 0.0,
        mesh=None,
        data_axis: Optional[str] = "data",
        cp_axis: Optional[str] = None,
        log_dir: Optional[str] = None,
        use_ema_eval: bool = False,
        reference_compat: bool = True,
        denoiser_impl: str = "module",  # "module" | "fused" | "fused_st" | "fused_full"
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
        names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
        data_axis = data_axis if data_axis in names else None
        cp_axis = cp_axis if cp_axis in names else None
        if cp_axis is not None:
            for name, value, whole in (("train_impl", train_impl, ("fused", "plain")),
                                       ("denoiser_impl", denoiser_impl, ("fused_st", "fused_full"))):
                if value in whole:
                    raise ValueError(
                        f"--{name} {value} runs on whole windows; it does not compose with "
                        f"context parallelism (the mesh's {cp_axis!r} axis): use the module "
                        "train step and --denoiser_impl fused or module")
        for name, value, allowed in (("denoiser_impl", denoiser_impl, VIDEO_DENOISER_IMPLS),
                                     ("train_impl", train_impl, TRAIN_IMPLS),
                                     ("dropout_impl", dropout_impl, DROPOUT_IMPLS)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        check_precisions(kernel_precision, (eval_matmul_precision, train_matmul_precision))
        if config.mixste is not None:
            x = config.mixste
            for name, value in (("denoiser_impl", denoiser_impl), ("train_impl", train_impl)):
                if value != "module":
                    raise ValueError(
                        f"--{name} {value}: the video kernels run SpatioTemporalDiff at hid 96 and "
                        f"4 heads; the MixSTE denoiser (embed {x.embed_dim}, depth {x.depth}, "
                        f"{x.num_heads} heads, MLP ratio {x.mlp_ratio}) runs on --{name} module")
            if mesh is not None:
                raise ValueError("the MixSTE denoiser runs on one device: no data or context mesh")
        self.config = config
        self.video_cfg = config.video or VideoConfig()
        self.seed = seed
        self.skip_type = skip_type
        self.eta = eta
        self.mesh = mesh
        self.data_axis, self.cp_axis = data_axis, cp_axis
        # this rank's place on the mesh's axes (trivial without a mesh)
        self._data, self._context = mesh_axis(mesh, data_axis), mesh_axis(mesh, cp_axis)
        if self.video_cfg.frames % self._context.size:
            raise ValueError(f"{self.video_cfg.frames}-frame windows do not split over "
                             f"{self._context.size} context ranks")
        self.log_dir = log_dir
        self.use_ema_eval = use_ema_eval
        self.reference_compat = reference_compat
        self.denoiser_impl = denoiser_impl
        self.train_impl = train_impl
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
            d.beta_schedule, beta_start=d.beta_start, beta_end=d.beta_end,
            num_diffusion_timesteps=d.num_diffusion_timesteps,
        )
        self.basis = cheb_basis_from_edges(config.model.n_pts, H36M_EDGES, order=2)
        self.mask = torch.ones((1, 1, config.model.n_pts), device=self.device)
        self._init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.model: Optional[torch.nn.Module] = None       # SpatioTemporalDiff or MixSTE
        self.state: Optional[TrainState] = None
        self.train_data: Optional[VideoDataset] = None
        self.test_data: Optional[VideoDataset] = None
        self.checkpointer: Optional[Checkpointer] = None
        if log_dir is not None:
            self.checkpointer = Checkpointer(log_dir)

        self.inference_times: List[float] = []
        self.eval_frames: int = 0
        self.train_seconds: List[float] = []     # per epoch, the train loop alone
        self._eval_cache: Dict[object, object] = {}

    # ------------------------------------------------------------------

    def create_video_model(self, model_path: Optional[str] = None):
        """The model at the config's widths (MixSTE where the config has its
        section, else ``SpatioTemporalDiff``), initialised from the runner's
        seed; ``model_path`` (a ``.pth`` of this runner's checkpoints) loads
        its weights strictly."""
        m, v, x = self.config.model, self.video_cfg, self.config.mixste
        init_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._init_generator))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(init_seed)
            if x is not None:
                model = MixSTE(
                    v.frames, n_pts=m.n_pts, coords_in=m.coords_dim[0], coords_out=m.coords_dim[1],
                    embed_dim=x.embed_dim, depth=x.depth, num_heads=x.num_heads,
                    mlp_ratio=x.mlp_ratio, qkv_bias=x.qkv_bias, ln_eps=x.ln_eps,
                    dropout_rate=x.dropout, attention_chunk=v.attention_chunk)
            else:
                model = SpatioTemporalDiff(
                    self.basis, v.frames, hid_dim=m.hid_dim, coords_in=m.coords_dim[0],
                    coords_out=m.coords_dim[1], num_layers=v.num_layers, num_heads=m.n_head,
                    dropout_rate=v.dropout, n_pts=m.n_pts, cp_axis=self.cp_axis,
                    attention_chunk=v.attention_chunk)
        if model_path:
            logger.info("initialize video model from %s", model_path)
            if not model_path.endswith(".pth"):
                raise ValueError(f"video model path {model_path!r}: only .pth checkpoints load here")
            model.load_state_dict(load_torch_states(model_path)[0], strict=True)
        model = model.to(self.device)
        self.model = model if x is not None else model.bind_mesh(self.mesh)
        return self.model

    def set_data(self, train: Optional[VideoDataset], test: Optional[VideoDataset]):
        self.train_data = train
        self.test_data = test
        for name, ds in (("training", train), ("testing", test)):
            if ds is not None:
                logger.info("%s windows: %d × %d frames", name, len(ds), ds.poses_3d.shape[1])

    def prepare_data(self):
        """Window datasets from the configured H3.6M npz pair."""
        from diffpose_tpu_torch.data.pipeline import prepare_h36m_sequences
        from diffpose_tpu_torch.data.video import make_video_windows

        d, v = self.config.data, self.video_cfg
        train_seq, test_seq = prepare_h36m_sequences(
            d.dataset_path, d.dataset_path_train_2d, d.dataset_path_test_2d)
        self.set_data(
            make_video_windows(*train_seq, frames=v.frames, stride=v.train_stride or v.frames),
            make_video_windows(*test_seq, frames=v.frames, stride=v.eval_stride or v.frames),
        )

    # ------------------------------------------------------------------

    def _make_loader(self, data: VideoDataset, shuffle: bool, keyed: bool = True) -> BatchLoader:
        """The batches of ``data``; ``keyed``: this rank's windows of each (its
        data coordinate's), else the global batches."""
        parts = (self._data.size, self._data.index) if keyed else (1, 0)
        return BatchLoader(data, batch_size=self.config.training.batch_size, shuffle=shuffle,
                           seed=self.seed, process_count=parts[0], process_index=parts[1])

    def train_tier(self) -> Optional[str]:
        """The tier the spatial blocks' train kernels (or their plain stack)
        run at, or None without such a stack (``--train_impl module``): the
        kernel tier, except that ``default`` trains them at the parity grade,
        as ``diffpose_tpu/train/video_runner.py:229`` passes
        ``kernel_precision or "bf16x3"``."""
        if self.train_impl not in ("fused", "plain"):
            return None
        return F32_KERNEL_GRADE if self.kernel_precision == "default" else self.kernel_precision

    def _build_train_step(self, steps_per_epoch: int):
        """The optimizer (the state's own, where a state with one exists) and
        the train step over it."""
        if self.state is not None and self.state.optimizer is not None:
            optimizer = self.state.optimizer
        else:
            o = self.config.optim
            optimizer = make_optimizer(
                self.model.parameters(), optimizer=o.optimizer, lr=o.lr, lr_gamma=o.lr_gamma,
                decay_epochs=o.decay, steps_per_epoch=steps_per_epoch, grad_clip=o.grad_clip,
                eps=o.eps)
        ema_mu = self.config.model.ema_rate if self.config.model.ema else None
        dropout = self.dropout_impl if self.train_impl != "module" else "masks"
        kwargs = dict(impl=self.train_impl, ema_mu=ema_mu, mask=self.mask, device=self.device,
                      dropout=dropout, tier=self.train_tier() or F32_KERNEL_GRADE)
        if self.mesh is not None:
            step_fn = make_sharded_video_train_step(self.model, optimizer, self.betas, self.mesh,
                                                    data_axis=self.data_axis,
                                                    cp_axis=self.cp_axis, **kwargs)
        else:
            step_fn = make_video_train_step(self.model, optimizer, self.betas, **kwargs)
        return optimizer, step_fn

    @under_matmul_grade("train")
    def train(self, resume: bool = False) -> Dict[str, list]:
        assert self.model is not None and self.train_data is not None
        warn_default_tier(self.train_tier())
        loader = self._make_loader(self.train_data, shuffle=True)
        steps_per_epoch = len(loader)
        optimizer, step_fn = self._build_train_step(steps_per_epoch)

        if self.state is None or self.state.optimizer is not optimizer:
            ema = ema_register(self.model) if self.config.model.ema else None
            self.state = TrainState.create(self.model, optimizer, ema_params=ema)
        if resume and self.checkpointer is not None and self.checkpointer.latest_step() is not None:
            self.state, _ = self.checkpointer.restore(self.state)
            logger.info("resumed from step %d (epoch %d)", int(self.state.step), int(self.state.epoch))

        history = {"loss": [], "p1": [], "p2": []}
        best_p1, best_epoch = float("inf"), -1
        self.train_seconds = []
        for epoch in range(int(self.state.epoch), self.config.training.n_epochs):
            t0 = time.time()
            step_losses = []
            # this rank's windows (the loader's keys), cut to its frames
            local = (shard_windows(self.mesh, b, None, self.cp_axis) for b in loader.epoch(epoch))
            for batch in prefetch_to_device(local, size=2, device=self.device):
                self.state, metrics = step_fn(self.state, batch, self.generator)
                step_losses.append(metrics["loss"].reshape(1))
            self.state.epoch = epoch + 1
            all_losses = torch.cat(step_losses)
            epoch_loss = AverageMeter()
            epoch_loss.update(float(all_losses.mean()), int(all_losses.shape[0]))  # the one sync
            history["loss"].append(epoch_loss.avg)
            self.train_seconds.append(time.time() - t0)
            logger.info("| Epoch %04d | steps %d | loss %.6f | %.2fs |",
                        epoch, steps_per_epoch, epoch_loss.avg, self.train_seconds[-1])
            if self.checkpointer is not None:
                barrier()
                if is_main_rank():
                    self.checkpointer.save(int(self.state.step), self.state)
                barrier()   # no rank reads a checkpoint before it is whole
            if self.test_data is not None:
                p1, p2 = self.evaluate(is_train=True)
                history["p1"].append(p1)
                history["p2"].append(p2)
                if p1 < best_p1:
                    best_p1, best_epoch = p1, epoch
                logger.info(
                    "| Best Epoch: %04d MPJPE: %.2f | Epoch: %04d MPJPE: %.2f PA-MPJPE: %.2f |",
                    best_epoch, best_p1, epoch, p1, p2)
        return history

    # ------------------------------------------------------------------

    def _get_eval_fn(self, seq):
        """The per-batch eval step: built once, reused every epoch (the
        weights flow in through the state)."""
        key = tuple(seq)
        if key not in self._eval_cache:
            t_cfg = self.config.testing
            kwargs = dict(test_times=t_cfg.test_times, eta=self.eta, mask=self.mask,
                          use_ema=self.use_ema_eval,
                          denoise_override=video_denoise_override(self.model, self.denoiser_impl,
                                                                  self.kernel_precision),
                          device=self.device, tier=self.kernel_precision)
            if self.mesh is not None:
                self._eval_cache[key] = make_sharded_video_eval_step(
                    self.model, self.betas, seq, self.mesh, frames_total=self.video_cfg.frames,
                    data_axis=self.data_axis, cp_axis=self.cp_axis, **kwargs)
            else:
                self._eval_cache[key] = make_video_eval_step(self.model, self.betas, seq, **kwargs)
        return self._eval_cache[key]

    @under_matmul_grade("eval")
    def evaluate(self, is_train: bool = False,
                 state: Optional[TrainState] = None) -> Tuple[float, float]:
        assert self.model is not None and self.test_data is not None
        t_cfg = self.config.testing
        seq = make_skip_sequence(self.skip_type, t_cfg.test_timesteps,
                                 t_cfg.test_num_diffusion_timesteps)
        if state is None:
            if self.state is None:
                self.state = TrainState.create(self.model, optimizer=None, ema_params=None)
            state = self.state
        was_training = self.model.training
        eval_fn = self._get_eval_fn(seq)
        with span("runner.prepare"):
            prepared = eval_fn.prepare(state)
        loader = self._make_loader(self.test_data, shuffle=False, keyed=False)
        acc = ActionErrorAccumulator(self.test_data.actions, num_joints=self.config.model.n_pts,
                                     reference_compat=self.reference_compat)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        self.inference_times = []
        for batch in loader.epoch(0):
            with span("runner.batch"):
                t0 = time.time()
                local = shard_windows(self.mesh, batch, self.data_axis, self.cp_axis)
                p1_b, p2_b, _ = eval_fn(state, local, self.generator, prepared=prepared)
                with span("runner.sync"):
                    sync()
                with span("runner.readback"):
                    # every rank's [B_local, F_local] block joined into [B, F]
                    p1_b, p2_b = (gather_windows(v, self._data, self._context).cpu().numpy()
                                  for v in (p1_b, p2_b))
                self.inference_times.append(time.time() - t0)
                # per-frame errors flatten; each frame inherits its window's action
                acc.add(batch, p1_b, p2_b, frames_per_item=p1_b.shape[1])
        self.model.train(was_training)

        self.eval_frames = acc.frames
        logger.info("MPJPE: %.4f | P-MPJPE: %.4f", acc.p1_meter.avg, acc.p2_meter.avg)
        return acc.summarize(print_table=not is_train)

    # ------------------------------------------------------------------

    def throughput_stats(self) -> Dict[str, float]:
        """Frames/s over the last evaluate() call (device-inclusive)."""
        total = sum(self.inference_times)
        return {
            "eval_frames": self.eval_frames,
            "eval_seconds": total,
            "frames_per_second": self.eval_frames / total if total > 0 else 0.0,
        }
