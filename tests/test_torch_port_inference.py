"""PyTorch port: the tiled full-frame inference path against the JAX package.

- `extract_tiles`/`stitch_tiles` round-trip exactly;
- the port's `denoise_frame` matches JAX's on one synthetic 48×80 frame
  with a small AFGSANet and identical weights (float32; only summation
  order differs, and expm1 in post-processing keeps it relative: 1e-4
  relative to the largest output);
- the device tiler (`make_fused_frame_apply`) reproduces the host loop
  exactly;
- `run_inference` end to end: a params `.npz` exported from an Orbax
  checkpoint by `tools/export_params_npz.py`, synthetic EXRs, and
  `evaluation.txt` in the JAX package's byte format;
- the entry points run on the card unless asked for the CPU, and the CLI
  never falls back to the CPU on its own.

The Mamba generator's frames: tests/test_torch_port_mamba_inference.py.
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
from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.training import checkpoints  # noqa: E402
from pixel_heal_thyself_tpu.utils.images import tensor2img as jtensor2img  # noqa: E402
from pixel_heal_thyself_tpu_torch import inference  # noqa: E402
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import (  # noqa: E402
    denoise_frame,
    denoise_frame_fused,
    extract_tiles,
    find_frame_pairs,
    load_generator,
    main,
    make_fused_frame_apply,
    run_inference,
    stitch_tiles,
    tensor2img,
)
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import afgsa_state_from_flax  # noqa: E402
from tools.export_params_npz import export_params_npz  # noqa: E402

SMALL = dict(base_ch=16, enc_ch=16, num_sa=1, num_gcp=0, num_heads=2)
SMALL_CFG = [
    "model.feature_map_channels=16", "+model.enc_channels=16",
    "model.afgsa.self_attention.num_layers=1",
    "model.afgsa.self_attention.num_heads=2", "trainer.precision=fp32",
]


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
    """The small model's flax param tree (names and shapes from `init`,
    traced without compiling), filled with seeded numpy values."""
    jmodel = JAFGSANet(**SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((1, 8, 8, 7)))["params"]
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = str(path[-1].key)
        scale = 1.0 if name.startswith("rel_") else (
            0.1 if name == "bias" else float(np.prod(leaf.shape[:-1])) ** -0.5)
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _small_models():
    jmodel = JAFGSANet(**SMALL, padding_mode="replicate")
    params = _small_params()
    model = AFGSANet(**SMALL, padding_mode="replicate").eval()
    model.load_state_dict(afgsa_state_from_flax(params))
    return jmodel, params, model


@pytest.mark.parametrize("shape", [(64, 96, 3), (50, 70, 2)])
def test_tiles_roundtrip(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    tiles, meta = extract_tiles(x, tile=32, margin=8)
    assert tiles.shape[1:] == (48, 48, shape[-1])
    np.testing.assert_array_equal(stitch_tiles(tiles, meta, 32, 8), x)


def test_denoise_frame_matches_jax():
    jmodel, params, model = _small_models()
    data = _frame(1, 48, 80)
    with jax.default_matmul_precision("highest"):
        want = jdenoise_frame(
            jax.jit(lambda n, a: jmodel.apply({"params": params}, n, a)),
            data, tile=16, margin=8, batch_tiles=4,
        )
    got = denoise_frame(model, data, tile=16, margin=8, batch_tiles=4, device="cpu")
    assert got.shape == want.shape == (48, 80, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("hw,batch", [((48, 80), 4), ((16, 32), 8)])
def test_fused_matches_host_loop(hw, batch):
    """Same windows and batches; the wrap-around padding tiles (2 tiles at
    batch 8 is all padding but two) must never overwrite real output."""
    _, _, model = _small_models()
    data = _frame(2, *hw)
    want = denoise_frame(model, data, tile=16, margin=8, batch_tiles=batch, device="cpu")
    fused = make_fused_frame_apply(model, hw, tile=16, margin=8, batch_tiles=batch,
                                   device="cpu")
    got = denoise_frame_fused(fused, data, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_tensor2img_matches_jax_utils():
    img = np.random.default_rng(3).uniform(-0.5, 3.0, (8, 8, 3))
    np.testing.assert_array_equal(tensor2img(img), jtensor2img(img))


def test_run_inference_end_to_end(tmp_path, tmp_cwd):
    _, params, model = _small_models()
    checkpoints.save_params(tmp_path / "state", {"g": {"params": params}})
    npz = tmp_path / "params.npz"
    assert export_params_npz(str(tmp_path / "state"), str(npz)) == len(
        jax.tree.leaves(params),
    )
    images = tmp_path / "images"
    generate_dataset(images, scenes=["fftle0_0", "taccturb_1_0"], height=48, width=80)
    cfg = ConfigRegistry.create_config(compose(
        "prod", [*SMALL_CFG, f"trainer.model_path={npz}"], resolve_interpolations=False,
    ))
    loaded = load_generator(cfg, device="cpu")
    for p, q in zip(loaded.state_dict().values(), model.state_dict().values()):
        assert torch.equal(p, q)

    out = tmp_path / "out"
    results = run_inference(cfg, str(images), str(out), tile=16, margin=8, batch_tiles=4,
                            save_exr=True, device="cpu")
    assert [r["scene"] for r in results] == ["fftle0_0", "taccturb_1_0"]
    text = (out / "taccturb_1_0_32_evaluation.txt").read_text()
    assert re.fullmatch(r"RMSE: \d+\.\d{6}\nPSNR: \d+\.\d{4}\n1-SSIM: -?\d+\.\d{6}\n", text)
    assert (out / "fftle0_0_32_denoised.exr").exists()
    assert [p[0] for p in find_frame_pairs(images, 32, 1024)] == ["fftle0_0", "taccturb_1_0"]

    # the CLI takes the same path and writes the same bytes
    out2 = tmp_path / "out_cli"
    main(["-cn", "prod", *SMALL_CFG, f"trainer.model_path={npz}",
          f"inference.images_dir={images}", f"inference.out_dir={out2}",
          "inference.tile=16", "inference.margin=8", "inference.batch_tiles=4",
          "inference.device=cpu"])
    assert (out2 / "taccturb_1_0_32_evaluation.txt").read_text() == text


def test_unported_paths_raise(tmp_path):
    """Spatial sharding with tensor parallelism (`parallel.model_axis` > 1)
    is not ported; with an exported artifact spatial sharding is refused as
    in the JAX package (artifacts serve the tiled path only)."""
    for model in ("afgsa", "mamba"):
        cfg = ConfigRegistry.create_config(compose("prod", [f"model={model}",
                                                            "parallel.model_axis=2"],
                                                   resolve_interpolations=False))
        with pytest.raises(NotImplementedError, match="not ported"):
            run_inference(cfg, str(tmp_path), str(tmp_path / "o"), device="cpu", spatial=True)
        with pytest.raises(ValueError, match="tiled path only"):
            run_inference(cfg, str(tmp_path), str(tmp_path / "o"), device="cpu", spatial=True,
                          from_export="artifact")


@pytest.mark.parametrize("fn", ["denoise_frame", "make_fused_frame_apply",
                                "denoise_frame_fused", "load_generator", "run_inference"])
def test_entry_points_default_to_cuda(fn):
    import inspect

    assert inspect.signature(getattr(inference, fn)).parameters["device"].default == "cuda"


def test_cli_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="inference.device=cpu"):
        main(["-cn", "prod", "trainer.model_path=absent.npz"])
