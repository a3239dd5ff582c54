"""PyTorch port: row-sharded AFGSA serving and `run_inference(spatial=True)`.

A gloo world of 4 CPU ranks (`spawn_world`, one torch thread a rank,
`init_method=file://`) runs `tests/torch_port_parallel_workers.spatial_rank`
with a 1-block AFGSANet (float32, weights from one seeded flax tree through
`params.afgsa_state_from_flax`); rank 0 saves the outputs:
- `sharded_apply_rows` against the JAX `sharded_apply_rows` under
  `shard_map` on 4 of the 8 virtual CPU devices: 1e-6 of the largest output
  (float32 convolutions and attention in another order), and against the
  port's model on the same strips with their halos put in by hand in this
  process: 1e-6 likewise;
- `denoise_frame_spatial` against the port's tiled `denoise_frame` at
  margin 24 ≥ the model's reach of 17 px: atol 2e-5, rtol 1e-4, the JAX
  package's bound (`tests/test_inference.py`).
A world of 2 runs `cli_rank`: `run_inference(spatial=True, device="cpu")`
of a small AFGSANet and a small MambaDenoiserNet on one synthetic scene,
each rank given an out dir of its own. Rank 0 writes the EXR and
`evaluation.txt` and returns the scores, rank 1 writes nothing and returns
[]; the EXR (half floats) equals, within one half-float ulp of its largest
value, the frame that one process computes: the AFGSA strips with their
halos by hand, the Mamba model on the whole frame.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.parallel.mesh import make_mesh  # noqa: E402
from pixel_heal_thyself_tpu.parallel.spatial import (  # noqa: E402
    sharded_apply_rows as jsharded_apply_rows,
)
from pixel_heal_thyself_tpu_torch import inference  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.data.exr import read_exr  # noqa: E402
from pixel_heal_thyself_tpu_torch.data.preprocessing import (  # noqa: E402
    postprocess_specular,
    preprocess_data,
)
from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel import distributed  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel.mesh import RowAxis  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel.spatial import make_sharded_apply_rows  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import afgsa_state_from_flax  # noqa: E402
from pixel_heal_thyself_tpu_torch.training.checkpoints import save_params  # noqa: E402

import torch_port_parallel_workers as workers  # noqa: E402

SMALL = dict(base_ch=16, enc_ch=16, num_sa=1, num_gcp=0, num_heads=2, padding_mode="replicate")
ROWS_MARGIN = 16
# reach: encoder 5×5 (2) + attention (block-1+halo = 10) + FFN (2) + decoder (3) = 17 px
FRAME_MARGIN = 24
AFGSA_CFG = ["model.feature_map_channels=16", "+model.enc_channels=16",
             "model.afgsa.self_attention.num_layers=1",
             "model.afgsa.self_attention.num_heads=2", "trainer.precision=fp32"]
MAMBA = dict(base_ch=16, enc_ch=16, num_blocks=2, d_state=8, headdim=8, expansion=2,
             num_gcp=0, padding_mode="replicate")
MAMBA_CFG = ["model=mamba", "model.feature_map_channels=16", "+model.enc_channels=16",
             "model.mamba.num_layers=2", "model.mamba.d_state=8", "model.mamba.headdim=8",
             "model.mamba.expansion=2", "trainer.precision=fp32"]
SCENE, CLI_MARGIN = "fftle0_0", 16


@pytest.fixture(autouse=True)
def _reset_port_run_dirs_cache():
    reset_run_dirs_cache()
    yield
    reset_run_dirs_cache()


@functools.lru_cache(maxsize=None)
def _flax_params() -> dict:
    """The small AFGSANet's flax tree (shapes from `init`), seeded values."""
    shapes = jax.eval_shape(JAFGSANet(**SMALL).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 7)))["params"]
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = str(path[-1].key)
        scale = 1.0 if name.startswith("rel_") else (
            0.1 if name == "bias" else float(np.prod(leaf.shape[:-1])) ** -0.5)
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model() -> AFGSANet:
    model = AFGSANet(**SMALL).eval()
    model.load_state_dict(afgsa_state_from_flax(_flax_params()))
    return model


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    rng = np.random.default_rng(3)
    rows = {"noisy": rng.uniform(0.05, 2.0, (1, 64, 24, 3)).astype(np.float32),
            "aux": rng.uniform(-1, 1, (1, 64, 24, 7)).astype(np.float32),
            "margin": ROWS_MARGIN}
    frame = {"data": {"noisy": rng.uniform(0.05, 2.0, (128, 40, 3)).astype(np.float32),
                      "aux": rng.uniform(-1, 1, (128, 40, 7)).astype(np.float32)},
             "margin": FRAME_MARGIN}
    state = {k: v.numpy() for k, v in afgsa_state_from_flax(_flax_params()).items()}
    return {"kwargs": SMALL, "state": state, "rows": rows, "frame": frame}


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory) -> dict:
    """The outputs of `workers.spatial_rank` over a gloo world of 4 CPU ranks."""
    out = tmp_path_factory.mktemp("spatial")
    distributed.spawn_world(workers.spatial_rank, 4, f"file://{out}/init", "cpu",
                            args=(str(out), _cases()), threads=1)
    return torch.load(out / "outputs.pt", weights_only=False)


def _hand_strips(apply_fn, noisy: np.ndarray, aux: np.ndarray, ranks: int,
                 margin: int) -> np.ndarray:
    """The row-sharded apply in one process: each strip with `margin` rows of
    its neighbours (the frame's edge row, replicated, at the top and bottom)
    through `apply_fn`, cropped, and the strips concatenated."""
    h = noisy.shape[1]
    strip = h // ranks

    def halo(x, r):
        lo, hi = r * strip, (r + 1) * strip
        up = x[:, lo - margin:lo] if r else np.repeat(x[:, :1], margin, axis=1)
        down = x[:, hi:hi + margin] if r < ranks - 1 else np.repeat(x[:, -1:], margin, axis=1)
        return torch.from_numpy(np.concatenate([up, x[:, lo:hi], down], axis=1))

    with torch.no_grad():
        outs = [apply_fn(halo(noisy, r), halo(aux, r))[:, margin:-margin] for r in range(ranks)]
    return torch.cat(outs, dim=1).numpy()


def test_ranks_import_no_jax(ranks_out):
    assert ranks_out["jax_loaded"] is False


def test_sharded_apply_rows_matches_jax(ranks_out):
    rows = _cases()["rows"]
    jmodel = JAFGSANet(**SMALL)
    mesh = make_mesh(data_axis=4, model_axis=1, devices=jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsharded_apply_rows(
            lambda n, a: jmodel.apply({"params": _flax_params()}, n, a), mesh, ROWS_MARGIN,
            jnp.asarray(rows["noisy"]), jnp.asarray(rows["aux"])))
    got = ranks_out["rows"]
    assert got.shape == want.shape == (1, 64, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_sharded_apply_rows_matches_strips_by_hand(ranks_out):
    rows = _cases()["rows"]
    want = _hand_strips(_port_model(), rows["noisy"], rows["aux"], 4, ROWS_MARGIN)
    np.testing.assert_allclose(ranks_out["rows"], want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_spatial_frame_matches_tiled_path(ranks_out):
    frame = _cases()["frame"]
    want = inference.denoise_frame(_port_model(), frame["data"], tile=16, margin=FRAME_MARGIN,
                                   batch_tiles=4, device="cpu")
    got = ranks_out["frame"]
    assert got.shape == want.shape == (128, 40, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_short_strips_and_ragged_heights_raise():
    data = _cases()["frame"]["data"]
    with pytest.raises(ValueError, match="strips >= margin"):
        inference.denoise_frame_spatial(lambda n, a: n, data, 8, margin=24, device="cpu")
    apply = make_sharded_apply_rows(lambda n, a: n, 8, RowAxis(4, 0, None))
    with pytest.raises(ValueError, match="not divisible"):
        apply(torch.zeros(1, 18, 8, 3), torch.zeros(1, 18, 8, 7))


# --- run_inference(spatial=True) at 2 ranks ---------------------------------------


@pytest.fixture(scope="module")
def cli_out(tmp_path_factory) -> dict:
    """Both models' `run_inference(spatial=True)` over a gloo world of 2 CPU
    ranks, and what one process computes for the same scene."""
    tmp = tmp_path_factory.mktemp("spatial_cli")
    images = tmp / "images"
    generate_dataset(images, scenes=[SCENE], height=64, width=48, seed=0)
    afgsa = _port_model()
    mamba = MambaDenoiserNet(**MAMBA, generator=torch.Generator().manual_seed(5)).eval()
    runs = {}
    for name, model, overrides in (("afgsa", afgsa, AFGSA_CFG), ("mamba", mamba, MAMBA_CFG)):
        save_params(tmp / f"{name}.pt", model)
        runs[name] = {"overrides": [*overrides, f"trainer.model_path={tmp / name}.pt"],
                      "images": str(images), "margin": CLI_MARGIN}
    distributed.spawn_world(workers.cli_rank, 2, f"file://{tmp}/init", "cpu",
                            args=(str(tmp), runs), threads=1)

    data = preprocess_data(str(images / "32spp" / f"{SCENE}_32"),
                           str(images / "1024spp" / f"{SCENE}_1024"))
    noisy_log, aux = inference._model_inputs(data)
    # AFGSA: the strips by hand, after the padding of `denoise_frame_spatial`
    pad = ((0, 0), (CLI_MARGIN, CLI_MARGIN), (0, 0))  # 64 rows, 48 columns: 16 and 8 divide
    strips = _hand_strips(afgsa, np.pad(noisy_log, pad, mode="edge")[None],
                          np.pad(aux, pad, mode="edge")[None], 2, CLI_MARGIN)
    # Mamba: the literal chain on the whole frame
    for blk in mamba.blocks:
        blk.mamba.use_megakernel = False
    with torch.no_grad():
        whole = mamba(torch.from_numpy(noisy_log[None]), torch.from_numpy(aux[None])).numpy()
    want = {"afgsa": postprocess_specular(strips[0, :, CLI_MARGIN:-CLI_MARGIN]),
            "mamba": postprocess_specular(whole[0])}
    return {"tmp": tmp, "want": want,
            "results": [torch.load(tmp / f"results_rank{r}.pt", weights_only=False)
                        for r in range(2)]}


@pytest.mark.parametrize("name", ["afgsa", "mamba"])
def test_run_inference_spatial_frames_match_one_process(cli_out, name):
    exr = read_exr(cli_out["tmp"] / f"{name}_rank0" / f"{SCENE}_32_denoised.exr")["default"]
    want = cli_out["want"][name]
    assert exr.shape == want.shape == (64, 48, 3)
    half_ulp = float(np.spacing(np.float16(np.abs(want).max())))
    np.testing.assert_allclose(exr.astype(np.float32), want, rtol=0, atol=half_ulp)


@pytest.mark.parametrize("name", ["afgsa", "mamba"])
def test_run_inference_spatial_only_rank0_writes(cli_out, name):
    rank0, rank1 = cli_out["results"]
    assert [r["scene"] for r in rank0[name]] == [SCENE] and rank1[name] == []
    assert not (cli_out["tmp"] / f"{name}_rank1").exists()
    files = sorted(p.name for p in (cli_out["tmp"] / f"{name}_rank0").iterdir())
    assert files == [f"{SCENE}_32_denoised.exr", f"{SCENE}_32_evaluation.txt"]
    text = (cli_out["tmp"] / f"{name}_rank0" / f"{SCENE}_32_evaluation.txt").read_text()
    assert re.fullmatch(r"RMSE: \d+\.\d{6}\nPSNR: \d+\.\d{4}\n1-SSIM: -?\d+\.\d{6}\n", text)
    assert all(np.isfinite(rank0[name][0][k]) for k in ("rmse", "psnr", "ssim"))

