"""PyTorch port: tiled full-frame Mamba denoising against the JAX package.

- a 48×80 frame through the port's host loop (`denoise_frame`) matches
  JAX `denoise_frame` with a small MambaDenoiserNet and one flax param
  tree, on both of the port's routes (float32; tile 16 + margin 8, so
  32² windows and l = 1024, a multiple of the model's chunk of 128; only
  summation order differs and expm1 in post-processing keeps it relative:
  1e-4 of the largest output);
- the device tiler (`make_fused_frame_apply`) reproduces the host loop;
- `run_inference(... model=mamba, device="cpu")` end to end: a params
  `.npz` exported from an Orbax checkpoint by `tools/export_params_npz.py`,
  synthetic EXRs, `evaluation.txt` in the JAX package's byte format, and
  the CLI writing the same bytes.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.inference import denoise_frame as jdenoise_frame  # noqa: E402
from pixel_heal_thyself_tpu.models.mamba import MambaDenoiserNet as JMamba  # noqa: E402
from pixel_heal_thyself_tpu.training import checkpoints  # noqa: E402
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import (  # noqa: E402
    denoise_frame,
    denoise_frame_fused,
    load_generator,
    main,
    make_fused_frame_apply,
    run_inference,
)
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import mamba_state_from_flax  # noqa: E402
from tools.export_params_npz import export_params_npz  # noqa: E402

SMALL = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16, headdim=32, expansion=4,
             num_gcp=0, padding_mode="replicate")
SMALL_CFG = [
    "model=mamba", "model.feature_map_channels=32", "+model.enc_channels=32",
    "model.mamba.num_layers=2", "model.mamba.d_state=16", "model.mamba.headdim=32",
    "trainer.precision=fp32",
]
TILES = dict(tile=16, margin=8, batch_tiles=4)


@pytest.fixture(autouse=True)
def _reset_port_run_dirs_cache():
    """The port's run-dirs cache is a process singleton of its own (the
    suite's conftest resets only the JAX package's); isolate tests."""
    reset_run_dirs_cache()
    yield
    reset_run_dirs_cache()


def _frame(seed, h, w):
    rng = np.random.default_rng(seed)
    return {
        "noisy": rng.uniform(0.05, 2.0, (h, w, 3)).astype(np.float32),
        "aux": rng.uniform(-1, 1, (h, w, 7)).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def _small_params() -> dict:
    shapes = jax.eval_shape(JMamba(**SMALL).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 7)))["params"]
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "A_log":
            return rng.uniform(0.0, 1.5, leaf.shape).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-4.0, -1.0, leaf.shape).astype(np.float32)
        if name in ("scale", "weight", "D"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan = float(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 10.0
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _small_model(fused: bool) -> MambaDenoiserNet:
    model = MambaDenoiserNet(**SMALL, use_kernels=True, use_megakernel=fused).eval()
    model.load_state_dict(mamba_state_from_flax(_small_params()))
    return model


@pytest.mark.parametrize("fused", [False, True])
def test_mamba_frame_matches_jax(fused):
    params = _small_params()
    data = _frame(1, 48, 80)
    jmodel = JMamba(**SMALL)
    with jax.default_matmul_precision("highest"):
        want = jdenoise_frame(jax.jit(lambda n, a: jmodel.apply({"params": params}, n, a)),
                              data, **TILES)
    got = denoise_frame(_small_model(fused), data, **TILES, device="cpu")
    assert got.shape == want.shape == (48, 80, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_mamba_fused_tiler_matches_host_loop():
    model = _small_model(True)
    data = _frame(2, 48, 80)
    want = denoise_frame(model, data, **TILES, device="cpu")
    fused = make_fused_frame_apply(model, (48, 80), **TILES, device="cpu")
    np.testing.assert_array_equal(denoise_frame_fused(fused, data, device="cpu"), want)


def test_run_inference_mamba_end_to_end(tmp_path, tmp_cwd):
    params = _small_params()
    checkpoints.save_params(tmp_path / "state", {"g": {"params": params}})
    npz = tmp_path / "params.npz"
    export_params_npz(str(tmp_path / "state"), str(npz))
    images = tmp_path / "images"
    generate_dataset(images, scenes=["fftle0_0"], height=48, width=80)
    cfg = ConfigRegistry.create_config(compose(
        "prod", [*SMALL_CFG, f"trainer.model_path={npz}"], resolve_interpolations=False,
    ))
    loaded = load_generator(cfg, device="cpu")
    assert isinstance(loaded, MambaDenoiserNet)
    assert loaded.blocks[0].mamba.fused_route(32 * 32)  # prod: use_pallas
    for p, q in zip(loaded.state_dict().values(), _small_model(True).state_dict().values()):
        assert torch.equal(p, q)

    out = tmp_path / "out"
    results = run_inference(cfg, str(images), str(out), **TILES, device="cpu")
    assert [r["scene"] for r in results] == ["fftle0_0"]
    text = (out / "fftle0_0_32_evaluation.txt").read_text()
    assert re.fullmatch(r"RMSE: \d+\.\d{6}\nPSNR: \d+\.\d{4}\n1-SSIM: -?\d+\.\d{6}\n", text)

    out2 = tmp_path / "out_cli"
    main(["-cn", "prod", *SMALL_CFG, f"trainer.model_path={npz}",
          f"inference.images_dir={images}", f"inference.out_dir={out2}",
          "inference.tile=16", "inference.margin=8", "inference.batch_tiles=4",
          "inference.device=cpu"])
    assert (out2 / "fftle0_0_32_evaluation.txt").read_text() == text
