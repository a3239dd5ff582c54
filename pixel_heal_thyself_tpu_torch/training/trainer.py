"""The training runtime: patch store build-if-missing, GAN loop, validation.

Port of `pixel_heal_thyself_tpu/training/trainer.py` (behavioural spec:
reference `pht/models/base_trainer.py:83-595` and the per-model trainers
`pht/models/afgsa/train.py:11-37`, `pht/models/mamba/train.py:13-45`):

- determinism seeded from cfg.seed; with `trainer.deterministic` (the
  default) also what the reference's `set_determinism` sets for torch
  (`deterministic_algorithms`: `CUBLAS_WORKSPACE_CONFIG=:4096:8` unless
  the caller set it, cuDNN's deterministic algorithms with no autotuning,
  `torch.use_deterministic_algorithms(True, warn_only=True)`), so that a
  run on the card repeats to the bit; padding replicate when
  deterministic, else reflect;
- the patch store built on first run (`data/store.py`), from synthetic
  scenes when `data.images.synthesize` and the image tree is missing;
- the GAN step of `training/train_step.py` with Adam and the MultiStep
  schedule: WGAN-GP against `DiscriminatorVGG` (the GP weights drawn from
  a `torch.Generator` on the device seeded from cfg.seed) or, with
  `model.discriminator.use_multiscale_discriminator`, the relativistic
  hinge against the spectral-norm `MultiScaleDiscriminator`; the optional
  MS-SSIM (`model.losses.use_ssim_loss`) and LPIPS (`use_lpips_loss`, its
  weights from `lpips_weights_path`: an npz of
  `tools/convert_lpips_weights.py`, or `random`) terms;
- per-epoch `train_loss.txt` lines `Epoch: N \\tG loss: x \\tD Loss: y`
  and, every `save_interval` epochs, validation with PSNR/SSIM/MRSE into
  `evaluation.txt` lines `Validation: N \\tAvg MRSE: a \\tAvg PSNR: b
  \\tAvg 1-SSIM: c`, PNG panels every `save_img_interval` samples and the
  whole train state under `model_epoch<N>/state/`, from which
  `trainer.load_model=true trainer.model_path=...` resumes.

Each rank trains on one device: the card unless the caller asks for the
CPU. On the card the generator runs through the hand kernels when
`trainer.use_pallas` (the block route for AFGSA, the fused Mamba2
interior for Mamba); on the CPU there are none, and it takes the plain
route, as the JAX trainer does off the TPU. The step syncs with the host
only on every 10th iteration. On the card each epoch logs its hand
kernels' launches and the peak device memory.

Several ranks (`parallel.multihost` under `python -m
torch.distributed.run`, or `PHT_COORDINATOR`/`PHT_NUM_PROCESSES`/
`PHT_PROCESS_ID`) train as the JAX trainer does on its ('data', 'model')
mesh: the process group is joined before the first device use, the ranks
form a D × M grid (`parallel.mesh.make_mesh`; `parallel.data_axis=-1`
resolves over the world size and the batch), each data index reads its
contiguous rows of every global batch from one shared epoch order
(`PrefetchLoader(host_bounds=...)`, the ragged last batch dropped), the
step reduces over the data group and shards Adam over the model group
(`training/train_step.py`), and validation runs replicated on every rank.
Only rank 0 builds the patch store (the others wait at a barrier that
every rank reaches whether or not a store was built) and writes files:
`train_loss.txt`, `evaluation.txt`, the panels, the checkpoints and the
profiler trace.
"""

from __future__ import annotations

import math
import os
import random
import time
from pathlib import Path

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch.data.dataset import DeviceLoader, PatchDataset, PrefetchLoader
from pixel_heal_thyself_tpu_torch.data.preprocessing import postprocess_specular
from pixel_heal_thyself_tpu_torch.data.store import PatchStoreConstructor, store_complete
from pixel_heal_thyself_tpu_torch.inference import (
    afgsa_kwargs_from_config,
    mamba_kwargs_from_config,
)
from pixel_heal_thyself_tpu_torch.logger import logger
from pixel_heal_thyself_tpu_torch.metrics import calculate_psnr, calculate_rmse, calculate_ssim
from pixel_heal_thyself_tpu_torch.models.afgsa import count_params
from pixel_heal_thyself_tpu_torch.parallel.distributed import (
    barrier,
    host_batch_bounds,
    is_main_process,
    maybe_initialize_distributed,
    process_count,
)
from pixel_heal_thyself_tpu_torch.parallel.mesh import Mesh, make_mesh
from pixel_heal_thyself_tpu_torch.training import checkpoints
from pixel_heal_thyself_tpu_torch.training.train_step import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
    multistep_milestone_epochs,
)
from pixel_heal_thyself_tpu_torch.utils.images import create_folder, save_img_group, tensor2img

_last_determinism_seed: list[int | None] = [None]


def set_determinism(seed: int, deterministic: bool) -> None:
    """Seed the host RNGs and torch's (reference `base_trainer.py:50-67`),
    then, when `deterministic`, `deterministic_algorithms()`. The seeding
    is re-applied whenever the seed changes, so every job of an in-process
    `-m seed=1,2,3` sweep is seeded from its own value."""
    if _last_determinism_seed[0] != seed:
        _last_determinism_seed[0] = seed
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
        os.environ["PYTHONHASHSEED"] = str(seed)
    if deterministic:
        deterministic_algorithms()


def deterministic_algorithms() -> None:
    """What the reference's `set_determinism` sets for torch
    (`base_trainer.py:50-80`): cuBLAS's deterministic workspace
    (`CUBLAS_WORKSPACE_CONFIG=:4096:8`, unless the caller set a value of
    its own), cuDNN's deterministic algorithms with no autotuning, and
    `torch.use_deterministic_algorithms(True, warn_only=True)`, which
    warns of each op that has no deterministic implementation and fills
    every `torch.empty` with NaN (so a read of memory that no kernel wrote
    shows). TF32 is left as the trainer sets it. These stay set for the
    rest of the process; callers that run other work after a trainer
    restore them (`tools.critic_numerics.arithmetic`). cuBLAS reads the
    workspace setting when it makes its first handle, so it is set before
    anything touches the card (`train.main`); set later, it is logged."""
    if "CUBLAS_WORKSPACE_CONFIG" not in os.environ and torch.cuda.is_initialized():
        logger.warning("CUBLAS_WORKSPACE_CONFIG is set to :4096:8 after CUDA was initialised: "
                       "a cuBLAS handle made before keeps its own workspace")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def training_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; a card that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda (the default) but no CUDA device is available; "
                           "pass --device cpu to train on the CPU")
    return device


def kernel_launches() -> dict:
    """The training path's hand kernels' launch counts so far in this
    process, by wrapper name (each wrapper counts its launches): the train
    step's, and K7, which the Mamba validation forward launches."""
    from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
        block_halo_attention_bwd_cuda,
        block_halo_attention_cuda,
    )
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
        conv3x3_cuda,
        conv3x3_dgrad_cuda,
        pointwise_gemm_cuda,
        weight_grad_cuda,
    )
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
        fused_mamba_chain_bwd_cuda,
        fused_mamba_chain_cuda,
        fused_mamba_chain_emit_cuda,
    )

    return {fn.__name__: fn.launches for fn in (
        block_halo_attention_cuda, pointwise_gemm_cuda, conv3x3_cuda,
        block_halo_attention_bwd_cuda, conv3x3_dgrad_cuda, weight_grad_cuda,
        fused_mamba_chain_cuda, fused_mamba_chain_emit_cuda, fused_mamba_chain_bwd_cuda)}


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class BaseTrainer:
    """Model-agnostic GAN trainer; subclasses provide the generator."""

    def __init__(self, cfg, device: torch.device | str = "cuda",
                 critic_dtype: torch.dtype | None = None, tf32: bool | None = None) -> None:
        """`critic_dtype` and `tf32` replace, for a diagnostic run (the
        quality campaign's diagnostic legs), the WGAN-GP critic's dtype
        (`models.discriminators.GP_CRITIC_DTYPE`) and the TF32 switch (on
        at bf16); no config key has them."""
        self.cfg = cfg
        self.device = training_device(device)
        self.deterministic = cfg.trainer.deterministic
        self.model_name = self.__class__.__name__.replace("Trainer", "")
        set_determinism(cfg.seed, self.deterministic)
        # join the process group before the first device use (and after
        # the determinism settings, which every rank applies); a rank's
        # card is then the current one
        if maybe_initialize_distributed(cfg.parallel.multihost, self.device) and \
                self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.padding_mode = "replicate" if self.deterministic else "reflect"
        if cfg.trainer.precision not in ("bf16", "fp32"):
            raise ValueError(
                f"trainer.precision must be 'bf16' or 'fp32', got {cfg.trainer.precision!r}",
            )
        self.compute_dtype = torch.bfloat16 if cfg.trainer.precision == "bf16" else torch.float32
        # fp32 is true float32 (the JAX trainer's HIGHEST matmul
        # precision); set both ways so that an in-process sweep over
        # precision does not leak one job's setting into the next
        tf32 = cfg.trainer.precision == "bf16" if tf32 is None else tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        self.critic_dtype = critic_dtype
        # the hand kernels exist on the card only
        self.use_kernels = bool(cfg.trainer.use_pallas) and self.device.type == "cuda"
        self.loader_kind: str | None = None
        self.store_build_seconds: float | None = None
        self.state: TrainState | None = None
        self.start_epoch = 0
        self.mesh = self._build_mesh()

    @property
    def is_main(self) -> bool:
        """Whether this rank writes the run's files (rank 0, or no process
        group)."""
        return is_main_process()

    def _build_mesh(self) -> Mesh:
        """The D × M grid of ranks from cfg.parallel (JAX `_build_mesh`);
        one rank with no process group is the 1 × 1 grid."""
        par, batch = self.cfg.parallel, self.cfg.trainer.batch_size
        mesh = make_mesh(par.data_axis, par.model_axis, batch)
        if batch % mesh.data:
            raise ValueError(f"trainer.batch_size={batch} must be divisible by the "
                             f"data-parallel degree {mesh.data}")
        if mesh.size > 1:
            logger.info(f"Mesh: {mesh.data} data x {mesh.model} model over "
                        f"{process_count()} ranks")
        return mesh

    # -- factories -------------------------------------------------------
    def create_generator(self) -> torch.nn.Module:
        raise NotImplementedError

    def create_discriminator(self) -> torch.nn.Module:
        from pixel_heal_thyself_tpu_torch.models.discriminators import (
            GP_CRITIC_DTYPE,
            DiscriminatorVGG,
            MultiScaleDiscriminator,
        )

        generator = torch.Generator().manual_seed(self.cfg.seed + 1)
        if self.cfg.model.discriminator.use_multiscale_discriminator:
            return MultiScaleDiscriminator(
                in_nc=self.cfg.model.input_channels,
                patch_size=self.cfg.data.patches.patch_size,
                dtype=self.compute_dtype, device=self.device, generator=generator,
            )
        return DiscriminatorVGG(
            in_nc=3, base_nf=64, input_size=self.cfg.data.patches.patch_size,
            dtype=self.critic_dtype or GP_CRITIC_DTYPE, device=self.device, generator=generator,
            data_group=self.mesh.data_group,
        )

    def lpips_params(self) -> dict | None:
        """LPIPS weights on the device when `use_lpips_loss`: `random`, or
        the npz at `lpips_weights_path`; neither raises."""
        losses = self.cfg.model.losses
        if not losses.use_lpips_loss:
            return None
        from pixel_heal_thyself_tpu_torch.models import lpips

        path = losses.lpips_weights_path
        if path == "random":
            logger.warning("LPIPS using RANDOM weights (test mode)")
            return lpips.random_lpips_params(device=self.device)
        if path:
            return lpips.load_lpips_params(path, device=self.device)
        raise ValueError(
            "use_lpips_loss=true requires model.losses.lpips_weights_path (see "
            "tools/convert_lpips_weights.py) or the value 'random'",
        )

    # -- data ------------------------------------------------------------
    def setup_dataloaders(self):
        cfg = self.cfg
        patches_dir = cfg.data.patches.dir
        # only rank 0 builds into the (shared) data dir: concurrent writers
        # would corrupt the store
        if self.is_main and not store_complete(patches_dir):
            if cfg.data.images.synthesize and not os.path.isdir(cfg.data.images.dir):
                from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset

                logger.info(f"Images dir {cfg.data.images.dir} missing — "
                            "generating synthetic scenes")
                generate_dataset(
                    cfg.data.images.dir,
                    height=cfg.data.images.synthetic_size,
                    width=cfg.data.images.synthetic_size,
                    noise_scale=cfg.data.images.synthetic_noise,
                    seed=cfg.seed,
                )
            logger.info(f"Creating dataset: patches in {patches_dir}")
            t0 = time.monotonic()
            PatchStoreConstructor(
                cfg.data.images.dir, patches_dir, cfg.data.patches.patch_size,
                cfg.data.patches.num_patches, cfg.seed, cfg.data_ratio,
                scale=cfg.data.images.scale, deterministic=self.deterministic,
            ).construct_store()
            self.store_build_seconds = time.monotonic() - t0
            logger.info(f"Built the patch store in {self.store_build_seconds:.2f} s")
        if process_count() > 1:
            # every rank, whether or not a store was built: a rank that
            # found the store complete and skipped its barrier would leave
            # rank 0 waiting here (and the step's collectives misaligned)
            barrier()

        train_ds = PatchDataset(os.path.join(patches_dir, "train"))
        val_ds = PatchDataset(os.path.join(patches_dir, "val"))
        dp = self.mesh.data
        host_bounds = (host_batch_bounds(cfg.trainer.batch_size, self.mesh.data_index, dp)
                       if dp > 1 else None)
        loader_kind = cfg.data.loader
        if loader_kind == "auto":
            fits = train_ds.nbytes + val_ds.nbytes <= cfg.data.device_cache_limit_gb * 1e9
            loader_kind = "device" if fits and process_count() == 1 else "native"
            logger.info(f"data.loader=auto resolved to {loader_kind!r}")
        self.loader_kind = loader_kind
        seed = cfg.seed if self.deterministic else None
        val_batch = max(1, cfg.trainer.val_batch_size)
        if loader_kind == "device":
            train_loader = DeviceLoader(train_ds, batch_size=cfg.trainer.batch_size,
                                        shuffle=True, seed=seed, drop_last=dp > 1,
                                        device=self.device)
            val_loader = DeviceLoader(val_ds, batch_size=val_batch, shuffle=False,
                                      device=self.device)
        elif loader_kind == "native":
            # a ragged last batch cannot split over the data group
            train_loader = PrefetchLoader(
                train_ds, batch_size=cfg.trainer.batch_size, shuffle=True, seed=seed,
                drop_last=dp > 1, prefetch=cfg.trainer.prefetch_batches,
                workers=cfg.trainer.num_workers, device=self.device, host_bounds=host_bounds,
            )
            val_loader = PrefetchLoader(val_ds, batch_size=val_batch, shuffle=False,
                                        prefetch=2, device=self.device)
        elif loader_kind == "grain":
            raise NotImplementedError(
                "data.loader=grain is not ported to pixel_heal_thyself_tpu_torch: the GPU "
                "machine has neither grain nor h5py (ROADMAP.md, 'Not to port'); use 'auto', "
                "'device' or 'native'",
            )
        else:
            raise ValueError(f"Unknown data.loader: {cfg.data.loader!r} "
                             "(expected 'auto', 'device', 'native' or 'grain')")
        return train_loader, val_loader, len(train_ds), len(val_ds)

    def print_training_config(self) -> None:
        cfg = self.cfg
        logger.info(f"Creating {self.model_name}")
        logger.info(f"{self.model_name} padding mode: {self.padding_mode}")
        logger.info(f"{self.model_name} curve order: {cfg.model.curve_order}")
        logger.info(f"{self.model_name} L1 lossW: {cfg.model.losses.l1_loss_w}")
        logger.info(f"{self.model_name} GAN lossW: {cfg.model.losses.gan_loss_w}")
        logger.info(f"{self.model_name} GP lossW: {cfg.model.losses.gp_loss_w}")
        logger.info(f"{self.model_name} precision: {cfg.trainer.precision}")
        if cfg.model.losses.use_ssim_loss:
            logger.info(f"{self.model_name} SSIM lossW: {cfg.model.losses.ssim_loss_w}")
        if cfg.model.discriminator.use_multiscale_discriminator:
            logger.info(f"{self.model_name} multiscale discriminator")
        if cfg.model.use_film:
            logger.info(f"{self.model_name} use FiLM")
        logger.info(f"{self.model_name} device: {self.device}, hand kernels: "
                    f"{'on' if self.use_kernels else 'off'}")

    # -- training --------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        logger.info(
            f"Starting training: model={self.model_name}, seed={cfg.seed}, "
            f"batch_size={cfg.trainer.batch_size}, epochs={cfg.trainer.epochs}",
        )
        logger.info(f"Loading dataset: patches from {cfg.data.patches.dir}")
        train_loader, val_loader, n_train, n_val = self.setup_dataloaders()

        self.print_training_config()
        g_model = self.create_generator()
        d_model = self.create_discriminator()

        batch_size = cfg.trainer.batch_size
        # as the loader: data parallelism drops the ragged last batch, so the
        # schedule's steps per epoch floor
        if self.mesh.data > 1:
            total_iterations = n_train // batch_size
        else:
            total_iterations = math.ceil(n_train / batch_size)
        milestones = multistep_milestone_epochs(cfg.trainer.epochs, cfg.trainer.lr_milestone)
        optim = dict(betas=tuple(cfg.trainer.optim.betas), eps=cfg.trainer.optim.eps)
        g_tx = make_optimizer(cfg.trainer.lr_g, milestones, cfg.trainer.lr_gamma,
                              total_iterations, **optim)
        d_tx = make_optimizer(cfg.trainer.lr_d, milestones, cfg.trainer.lr_gamma,
                              total_iterations, **optim)
        step_fn = make_train_step(
            g_model, d_model, cfg.model.losses,
            cfg.model.discriminator.use_multiscale_discriminator, g_tx, d_tx,
            lpips_params=self.lpips_params(), mesh=self.mesh,
        )
        # one GP generator, seeded alike on every rank: each rank takes its
        # rows of the same global draw
        state = TrainState(
            g=g_model, d=d_model, g_opt=step_fn.g_opt, d_opt=step_fn.d_opt,
            g_sched=step_fn.g_sched, d_sched=step_fn.d_sched,
            generator=torch.Generator(device=self.device).manual_seed(cfg.seed),
            g_shards=step_fn.g_shards, d_shards=step_fn.d_shards,
        )
        self.state = state

        start_epoch = 0
        if cfg.trainer.load_model and cfg.trainer.model_path:
            # every rank reads the same files: the ranks start equal
            start_epoch = checkpoints.restore_checkpoint(cfg.trainer.model_path, state) + 1
            logger.info(f"Resumed from {cfg.trainer.model_path} at epoch {start_epoch}")
        self.start_epoch = start_epoch

        logger.info(f"{self.model_name} G params: {count_params(g_model):,} | "
                    f"D params: {count_params(d_model):,}")
        eval_fn = make_eval_step(g_model)

        root_save_path = cfg.paths.output_dir
        if self.is_main:
            os.makedirs(root_save_path, exist_ok=True)
        save_img_interval = max(1, n_val // max(1, cfg.trainer.num_saved_imgs))

        logger.info("Start training")
        for epoch in range(start_epoch, cfg.trainer.epochs):
            start = time.time()
            comm_start, launches_start = step_fn.comm_seconds, kernel_launches()
            # losses stay on the device during the epoch: the host syncs
            # only on logging iterations
            epoch_metrics: list[dict] = []
            end = start
            i_batch = -1
            io_total = 0.0
            prof = None
            for i_batch, batch in enumerate(train_loader):
                io_took = time.time() - end
                io_total += io_took
                # a profiler trace of a steady window of the first epoch;
                # short epochs clamp the window so the trace always closes
                if (cfg.trainer.profile_dir and self.is_main and epoch == start_epoch
                        and total_iterations >= 2):
                    prof_start = min(10, max(0, total_iterations - 2))
                    prof_stop = min(15, total_iterations - 1)
                    if i_batch == prof_start:
                        prof = self._start_profiler()
                    elif i_batch == prof_stop and prof is not None:
                        self._stop_profiler(prof)
                        prof = None
                metrics = step_fn(batch, generator=state.generator)
                epoch_metrics.append(metrics)
                if i_batch % 10 == 0 or i_batch == total_iterations - 1:
                    # the host sync, on logging iterations only
                    g_l = float(metrics["g_loss"])
                    d_l = float(metrics["d_loss"])
                    iter_took = time.time() - end
                    logger.debug(
                        f"[Train] epoch={epoch + 1} iter={i_batch + 1}/{total_iterations} "
                        f"g_loss={g_l / batch_size:.4f} d_loss={d_l / batch_size:.4f} "
                        f"iter_time={iter_took:.2f}s io_time={io_took:.2f}s",
                    )
                end = time.time()

            n_iters = i_batch + 1
            epoch_g = self._loss_sum(epoch_metrics, "g_loss") / batch_size / max(1, n_iters)
            epoch_d = self._loss_sum(epoch_metrics, "d_loss") / batch_size / max(1, n_iters)
            # io share = time the step loop spent blocked in the loader;
            # over several ranks, the host seconds in the step's gradient
            # and parameter collectives
            comm = (f" collectives {step_fn.comm_seconds - comm_start:.2f}s"
                    if self.mesh.size > 1 else "")
            logger.info(
                f"[Train] epoch={epoch + 1} summary: g_loss={epoch_g:.4f} "
                f"d_loss={epoch_d:.4f} time={int(end - start)}s "
                f"({n_train / max(1e-9, end - start):.1f} patches/sec, "
                f"io {io_total:.1f}s = "
                f"{100 * io_total / max(1e-9, end - start):.0f}%){comm}",
            )
            if self.use_kernels:
                launched = {k: v - launches_start[k] for k, v in kernel_launches().items()}
                logger.info(f"[Train] epoch={epoch + 1} kernel launches: "
                            + ", ".join(f"{k} {v}" for k, v in launched.items() if v)
                            + f"; peak memory {torch.cuda.max_memory_allocated(self.device)} B")
            if self.is_main:
                with open(os.path.join(root_save_path, "train_loss.txt"), "a") as f:
                    f.write(f"Epoch: {epoch + 1} \tG loss: {epoch_g:.4f} "
                            f"\tD Loss: {epoch_d:.4f}\n")

            if epoch % cfg.trainer.save_interval == 0:
                self._validate_and_save(epoch, state, eval_fn, val_loader, n_val,
                                        root_save_path, save_img_interval)

    @staticmethod
    def _loss_sum(epoch_metrics: list[dict], key: str) -> float:
        """The epoch's float32 sum of one loss (numpy's, as the JAX trainer
        sums its per-step losses)."""
        if not epoch_metrics:
            return 0.0
        return float(np.sum(torch.stack([m[key] for m in epoch_metrics]).float().cpu().numpy()))

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof) -> None:
        prof.stop()
        os.makedirs(self.cfg.trainer.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.trainer.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info(f"Wrote profiler trace to {path}")

    # -- validation ------------------------------------------------------
    def _validate_and_save(
        self,
        epoch: int,
        state: TrainState,
        eval_fn,
        val_loader,
        n_val: int,
        root_save_path: str,
        save_img_interval: int,
    ) -> None:
        # every rank runs the (replicated) eval forwards and takes part in
        # the checkpoint's gathers; only rank 0 touches the run directory
        current_save_path = None
        if self.is_main:
            current_save_path = create_folder(os.path.join(root_save_path,
                                                           f"model_epoch{epoch + 1}"))
        checkpoints.save_checkpoint(current_save_path and Path(current_save_path) / "state",
                                    state, epoch)

        start = time.time()
        avg_mrse, avg_psnr, avg_ssim = self.validate(eval_fn, val_loader, n_val,
                                                     current_save_path, save_img_interval)
        end = time.time()
        logger.info(
            f"[Val] epoch={epoch + 1} summary: avg_mrse={avg_mrse:.4f} "
            f"avg_psnr={avg_psnr:.4f} avg_1-ssim={1 - avg_ssim:.4f} "
            f"time={int(end - start)}s",
        )
        if self.is_main:
            with open(os.path.join(root_save_path, "evaluation.txt"), "a") as f:
                f.write(
                    f"Validation: {epoch + 1} \tAvg MRSE: {avg_mrse:.4f} "
                    f"\tAvg PSNR: {avg_psnr:.4f} \tAvg 1-SSIM: {1 - avg_ssim:.4f}\n",
                )


    def validate(self, eval_fn, val_loader, n_val: int, save_path: str | None = None,
                 save_img_interval: int = 1) -> tuple[float, float, float]:
        """The validation pass: (mean RMSE, PSNR, SSIM) over `val_loader`'s
        `n_val` samples; rank 0 writes every `save_img_interval`-th sample's
        panels into `save_path` when it is given."""
        avg_psnr = avg_ssim = avg_mrse = 0.0
        # the metric functions batch-SUM 4-d inputs (reference quirk) and
        # panels are keyed by global sample index, so any val batch size
        # gives the reference's batch-1 values and artifact set
        sample_base = 0
        for batch in val_loader:
            output, noisy, gt = (_numpy(x) for x in eval_fn(batch))
            output_lin = postprocess_specular(output.astype(np.float64))
            gt_lin = gt.astype(np.float64)
            noisy_255 = tensor2img(noisy, post_spec=True)
            output_255 = tensor2img(output, post_spec=True)
            gt_255 = tensor2img(gt_lin)

            for j in range(output_255.shape[0] if self.is_main and save_path else 0):
                idx = sample_base + j
                if idx % save_img_interval == 0:
                    save_img_group(save_path, idx, noisy_255[j], output_255[j], gt_255[j])
            sample_base += output_255.shape[0]

            avg_mrse += calculate_rmse(output_lin, gt_lin)
            avg_psnr += calculate_psnr(output_255, gt_255)
            avg_ssim += calculate_ssim(output_255, gt_255)
        return avg_mrse / n_val, avg_psnr / n_val, avg_ssim / n_val


class AFGSATrainer(BaseTrainer):
    """AFGSA generator factory (reference `pht/models/afgsa/train.py`)."""

    def create_generator(self) -> torch.nn.Module:
        from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet

        kwargs = afgsa_kwargs_from_config(self.cfg)
        if not self.use_kernels:
            kwargs.update(use_kernels=False, use_block_kernel=False, fold_qkv=False)
        return AFGSANet(**kwargs, device=self.device,
                        generator=torch.Generator().manual_seed(self.cfg.seed))


class MambaTrainer(BaseTrainer):
    """Mamba generator factory (reference `pht/models/mamba/train.py`).
    The fused conv1d + SiLU stays off, as the JAX trainer hard-wires it."""

    def create_generator(self) -> torch.nn.Module:
        from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet

        kwargs = mamba_kwargs_from_config(self.cfg)
        if not self.use_kernels:
            kwargs.update(use_kernels=False, use_megakernel=False)
        return MambaDenoiserNet(**kwargs, device=self.device,
                                generator=torch.Generator().manual_seed(self.cfg.seed))
