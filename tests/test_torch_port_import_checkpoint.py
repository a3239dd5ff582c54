"""PyTorch port: importing reference checkpoints (`G.pt`/`D.pt`) with
`tools.import_torch_checkpoint`, against the JAX package's importer.

A reference-layout state dict is built by inverting the layouts of a JAX
`model.init` tree (the tree's names and shapes, filled with seeded numpy
values so that a transposed or misplaced weight cannot pass), with the
keys the importers drop: the curve buffers, `pos_encoder.pe`, BatchNorm
running stats and `attention.alpha`. Then:
- the JAX tool's converter maps that dict back to the same tree exactly,
  so the dict is what the reference saves;
- the port's tool (its command line, `save_params`) and
  `inference.load_generator` give a port model whose forward matches the
  JAX model on that tree within 1e-4 of the largest output (float32;
  summation order only): AFGSANet with and without FiLM, the Mamba
  denoiser, and DiscriminatorVGG (per-batch BatchNorm);
- a key the mapping does not take raises KeyError.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.models.mamba import MambaDenoiserNet as JMamba  # noqa: E402
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import load_generator  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.tools import import_torch_checkpoint as port_tool  # noqa: E402
from pixel_heal_thyself_tpu_torch.training import checkpoints  # noqa: E402
from tools import import_torch_checkpoint as jax_tool  # noqa: E402

HW = 32
NUM_GCP = 1  # the JAX tree names the last block CheckpointTransformerBlock_0
AFGSA = dict(base_ch=16, enc_ch=16, num_sa=2, num_heads=2, padding_mode="replicate")
AFGSA_CFG = ["model.feature_map_channels=16", "+model.enc_channels=16",
             "model.afgsa.self_attention.num_layers=2",
             "model.afgsa.self_attention.num_heads=2", "trainer.precision=fp32",
             f"model.num_gradient_checkpoints={NUM_GCP}"]
MAMBA = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16, headdim=32, expansion=4,
             padding_mode="replicate")
MAMBA_CFG = ["model=mamba", "model.feature_map_channels=32", "+model.enc_channels=32",
             "model.mamba.num_layers=2", "model.mamba.d_state=16", "model.mamba.headdim=32",
             "trainer.precision=fp32", f"model.num_gradient_checkpoints={NUM_GCP}"]


@pytest.fixture(autouse=True)
def _reset_port_run_dirs_cache():
    reset_run_dirs_cache()
    yield
    reset_run_dirs_cache()


def _jax_model(kind: str, use_film: bool = False):
    if kind == "afgsa":
        return JAFGSANet(**AFGSA, num_gcp=NUM_GCP, use_film=use_film)
    if kind == "mamba":
        return JMamba(**MAMBA, num_gcp=NUM_GCP)
    return JDiscriminatorVGG(input_size=16, base_nf=8)


def _jax_inputs(kind: str) -> tuple:
    rng = np.random.default_rng(1)
    if kind == "discriminator_vgg":
        return (rng.standard_normal((3, 16, 16, 3)).astype(np.float32),)
    return (rng.uniform(0, 2, (2, HW, HW, 3)).astype(np.float32),
            rng.standard_normal((2, HW, HW, 7)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _tree(kind: str, use_film: bool = False) -> dict:
    """The JAX model's `init` param tree, seeded numpy values, nested dicts."""
    x = tuple(jnp.asarray(t[:1]) for t in _jax_inputs(kind))
    shapes = jax.eval_shape(_jax_model(kind, use_film).init, jax.random.PRNGKey(0), *x)
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "A_log":
            return rng.uniform(0.0, 1.5, leaf.shape).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-4.0, -1.0, leaf.shape).astype(np.float32)
        if name in ("scale", "weight", "D"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan = float(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    return jax.tree.map(np.asarray, dict(tree))


def _conv_t(kernel: np.ndarray) -> np.ndarray:
    """flax Conv [kh, kw, Ci, Co] → torch Conv2d [Co, Ci, kh, kw]."""
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


_SKELETON = {f"ConvBlock_{i}": name for i, name in enumerate(
    ["conv1", "conv3", "conv5", "conv_map", "conv_a1", "conv_a3", "conv_a5", "conv_aenc1",
     "conv_aenc2", "decoder.0", "decoder.1", "decoder.2"])}
_FFN = {"ConvBlock_0": "feed_forward.0.0", "ConvBlock_1": "feed_forward.1.0"}


def _block_order(tree: dict, kind: str) -> list[str]:
    """The JAX tree's block names in model order (plain, then remat)."""
    plain = sorted((k for k in tree if k.startswith(f"{kind}Block_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    remat = sorted((k for k in tree if k.startswith(f"Checkpoint{kind}Block_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    return plain + remat


def _generator_sd(tree: dict, kind: str) -> dict:
    """A reference generator state dict inverting `tree`'s layouts."""
    sd = {}
    for flax, ref in _SKELETON.items():
        sd[f"{ref}.0.weight"] = _conv_t(tree[flax]["Conv_0"]["kernel"])
        sd[f"{ref}.0.bias"] = tree[flax]["Conv_0"]["bias"]
    blocks = "Transformer" if kind == "afgsa" else "Mamba"
    for i, name in enumerate(_block_order(tree, blocks)):
        node = tree[name]
        t = f"transformer_blocks.{i}" if kind == "afgsa" else f"mamba_blocks.{i}"
        for flax, ref in _FFN.items():
            sd[f"{t}.{ref}.weight"] = _conv_t(node[flax]["Conv_0"]["kernel"])
            sd[f"{t}.{ref}.bias"] = node[flax]["Conv_0"]["bias"]
        if kind == "afgsa":
            att = node["attention"]
            if "ConvBlock_0" in att:
                conv = att["ConvBlock_0"]["Conv_0"]
                sd[f"{t}.attention.conv_map.0.weight"] = _conv_t(conv["kernel"])
                sd[f"{t}.attention.conv_map.0.bias"] = conv["bias"]
            if "FiLM_0" in att:
                for j, k in (("Conv_0", 0), ("Conv_1", 2)):
                    conv = att["FiLM_0"][j]
                    sd[f"{t}.attention.film.affine.{k}.weight"] = _conv_t(conv["kernel"])
                    sd[f"{t}.attention.film.affine.{k}.bias"] = conv["bias"]
            for proj in ("q_conv", "k_conv", "v_conv"):
                sd[f"{t}.attention.{proj}.weight"] = _conv_t(att[proj]["kernel"])
            win, half = att["rel_h"].shape
            sd[f"{t}.attention.rel_h"] = att["rel_h"].reshape(1, win, 1, half)
            sd[f"{t}.attention.rel_w"] = att["rel_w"].reshape(1, 1, win, half)
            # dropped by both importers
            sd[f"{t}.attention.curve_indices"] = np.arange(64, dtype=np.float32)
            sd[f"{t}.attention.inv_curve_indices"] = np.arange(64, dtype=np.float32)
            sd[f"{t}.attention.alpha"] = np.ones(1, np.float32)
        else:
            m = node["mamba"]
            sd[f"{t}.norm1.weight"] = node["norm1"]["scale"]
            sd[f"{t}.norm1.bias"] = node["norm1"]["bias"]
            sd[f"{t}.mamba.in_proj.weight"] = np.ascontiguousarray(m["in_proj"]["kernel"].T)
            sd[f"{t}.mamba.conv1d.weight"] = np.ascontiguousarray(m["conv1d_weight"].T[:, None])
            for name_ in ("conv1d_bias", "dt_bias", "A_log", "D"):
                key = "conv1d.bias" if name_ == "conv1d_bias" else name_
                sd[f"{t}.mamba.{key}"] = m[name_]
            sd[f"{t}.mamba.norm.weight"] = m["norm"]["weight"]
            sd[f"{t}.mamba.out_proj.weight"] = np.ascontiguousarray(m["out_proj"]["kernel"].T)
    if kind == "mamba":
        sd["pos_encoder.pe"] = np.zeros((1, 32, HW, HW), np.float32)  # dropped
    return sd


def _discriminator_sd(tree: dict) -> dict:
    """A reference DiscriminatorVGG state dict: features.<i>.{0,1} and the
    classifier, whose first Linear reads the 4×4 map in (C, H, W) order."""
    sd = {}
    for name, node in tree.items():
        if not name.startswith("ConvBlock_"):
            continue
        i = name.split("_")[1]
        sd[f"features.{i}.0.weight"] = _conv_t(node["Conv_0"]["kernel"])
        sd[f"features.{i}.0.bias"] = node["Conv_0"]["bias"]
        if "BatchNorm2d_0" in node:
            sd[f"features.{i}.1.weight"] = node["BatchNorm2d_0"]["scale"]
            sd[f"features.{i}.1.bias"] = node["BatchNorm2d_0"]["bias"]
            c = node["BatchNorm2d_0"]["scale"].shape[0]
            sd[f"features.{i}.1.running_mean"] = np.zeros(c, np.float32)  # dropped
            sd[f"features.{i}.1.running_var"] = np.ones(c, np.float32)
            sd[f"features.{i}.1.num_batches_tracked"] = np.zeros((), np.float32)
    w = tree["Dense_0"]["kernel"].T  # [100, H·W·C]
    ch = w.shape[1] // 16
    sd["classifier.0.weight"] = np.ascontiguousarray(
        w.reshape(w.shape[0], 4, 4, ch).transpose(0, 3, 1, 2).reshape(w.shape[0], -1))
    sd["classifier.0.bias"] = tree["Dense_0"]["bias"]
    sd["classifier.2.weight"] = np.ascontiguousarray(tree["Dense_1"]["kernel"].T)
    sd["classifier.2.bias"] = tree["Dense_1"]["bias"]
    return sd


def _reference_sd(kind: str, use_film: bool = False) -> dict:
    tree = _tree(kind, use_film)
    return _discriminator_sd(tree) if kind == "discriminator_vgg" else _generator_sd(tree, kind)


def _jax_converted(kind: str, sd: dict, use_film: bool) -> dict:
    if kind == "afgsa":
        return jax_tool.convert_afgsa_generator(sd, NUM_GCP, use_film)
    if kind == "mamba":
        return jax_tool.convert_mamba_generator(sd, NUM_GCP)
    return jax_tool.convert_discriminator_vgg(sd)


def _flat(tree: dict) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


CASES = [("afgsa", False), ("afgsa", True), ("mamba", False), ("discriminator_vgg", False)]
IDS = ["afgsa", "afgsa-film", "mamba", "discriminator_vgg"]


@pytest.mark.parametrize("kind,use_film", CASES, ids=IDS)
def test_reference_dict_inverts_the_jax_import(kind, use_film):
    """The JAX converter maps the built dict back to the init tree exactly."""
    want = _flat(_tree(kind, use_film))
    got = _flat(_jax_converted(kind, _reference_sd(kind, use_film), use_film))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _jax_forward(kind: str, use_film: bool, inputs: tuple) -> np.ndarray:
    jmodel = _jax_model(kind, use_film)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(jmodel.apply)({"params": _tree(kind, use_film)},
                                    *(jnp.asarray(x) for x in inputs))
    return np.asarray(out)


@pytest.mark.parametrize("kind,use_film", CASES, ids=IDS)
def test_imported_checkpoint_matches_jax_forward(tmp_path, tmp_cwd, kind, use_film):
    """`G.pt`/`D.pt` → the port's command line → the port model: its
    forward matches the JAX model on the same tree."""
    g = tmp_path / "G.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                _reference_sd(kind, use_film).items()}, g)
    out = tmp_path / "imported.pt"
    argv = ["--model", kind, "--g", str(g), "--out", str(out), "--num-gcp", str(NUM_GCP)]
    port_tool.main(argv + (["--use-film"] if use_film else []))

    inputs = _jax_inputs(kind)
    want = _jax_forward(kind, use_film, inputs)
    if kind == "discriminator_vgg":
        model = DiscriminatorVGG(input_size=16, base_nf=8)
        model.load_state_dict(checkpoints.restore_params(out))
    else:
        overrides = [*(AFGSA_CFG if kind == "afgsa" else MAMBA_CFG),
                     f"trainer.model_path={out}"]
        if use_film:
            overrides.append("model.use_film=true")
        cfg = ConfigRegistry.create_config(compose("prod", overrides,
                                                   resolve_interpolations=False))
        model = load_generator(cfg, device="cpu")
        assert model.num_gcp == NUM_GCP
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["afgsa", "mamba", "discriminator_vgg"])
def test_unmapped_keys_raise(kind):
    sd = dict(_reference_sd(kind), **{"extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unmapped reference state_dict keys"):
        port_tool.convert(kind, sd)
