"""PyTorch port: exported serving artifacts (`serving.py`,
`tools/export_model.py`, `inference.from_export`) against the live port
model and the JAX package's artifacts.

Mirrors tests/test_serving.py case by case (round trip, Mamba, the
portable multi-platform rebuild, the unknown export option, manifest
fields, version gate, platform mismatch, `denoise_frame` and the fused
tiler through the artifact), and adds:
- an fp32 artifact equals the live port model to the bit (the loaded
  graph runs the same ops in the same order);
- each graph holds the stated `pht::` kernel ops: `num_sa` ×
  `transformer_block_fwd` on the block route, `num_sa` ×
  `block_halo_attention` on the literal route, under FiLM and under
  `fold_qkv`, `num_blocks` × `fused_mamba_chain` on the fused Mamba route,
  none in the portable artifact;
- the port's fp32 artifacts match the JAX artifacts of the same flax
  params within 1e-4 of the largest output (float32; summation order
  only), the bf16 block route within 5e-2 of the JAX fp32 artifact;
- a route whose kernel is not an op (the Mamba literal route's fused
  conv, `use_pallas`) fails the export instead of exporting other ops;
- `run_inference(from_export=...)` writes the live model's
  `evaluation.txt`, and a fresh process serves an artifact without
  importing any model class.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.mamba import MambaDenoiserNet as JMamba  # noqa: E402
from pixel_heal_thyself_tpu.serving import export_denoiser as jexport_denoiser  # noqa: E402
from pixel_heal_thyself_tpu.serving import load_exported as jload_exported  # noqa: E402
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import (  # noqa: E402
    denoise_frame,
    denoise_frame_fused,
    main,
    make_fused_frame_apply,
    run_inference,
)
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    mamba_state_from_flax,
)
from pixel_heal_thyself_tpu_torch.serving import (  # noqa: E402
    ARTIFACT_VERSION,
    MANIFEST_FILE,
    MODULE_FILE,
    export_denoiser,
    load_exported,
    load_manifest,
)
from pixel_heal_thyself_tpu_torch.tools import export_model  # noqa: E402
from pixel_heal_thyself_tpu_torch.training import checkpoints  # noqa: E402

AFGSA = dict(base_ch=16, enc_ch=16, num_sa=2, num_gcp=0, num_heads=2, padding_mode="replicate")
AFGSA_CFG = [
    "model.feature_map_channels=16", "+model.enc_channels=16",
    "model.afgsa.self_attention.num_layers=2",
    "model.afgsa.self_attention.num_heads=2", "trainer.precision=fp32",
]
MAMBA = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16, headdim=32, expansion=4,
             num_gcp=0, padding_mode="replicate")
WINDOW, BATCH = 32, 2  # 32² windows: l = 1024, a multiple of the Mamba chunk of 128
TILES = dict(tile=16, margin=8, batch_tiles=BATCH)


@pytest.fixture(autouse=True)
def _reset_port_run_dirs_cache():
    reset_run_dirs_cache()
    yield
    reset_run_dirs_cache()


def _fill(rng, path, leaf):
    name = str(path[-1].key)
    if name == "A_log":
        return rng.uniform(0.0, 1.5, leaf.shape).astype(np.float32)
    if name == "dt_bias":
        return rng.uniform(-4.0, -1.0, leaf.shape).astype(np.float32)
    if name in ("scale", "weight", "D"):
        return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    if name.startswith("rel_"):
        return rng.standard_normal(leaf.shape).astype(np.float32)
    if name == "bias":
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return (rng.standard_normal(leaf.shape) * float(np.prod(leaf.shape[:-1])) ** -0.5
            ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flax_params(kind: str) -> dict:
    """Seeded numpy values in the flax tree of the small JAX model."""
    jmodel = _jax_model(kind)
    x = jnp.zeros((1, WINDOW, WINDOW, 3))
    a = jnp.zeros((1, WINDOW, WINDOW, 7))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, a)["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map_with_path(functools.partial(_fill, rng), shapes)


def _jax_model(kind: str):
    return JAFGSANet(**AFGSA) if kind == "afgsa" else JMamba(**MAMBA)


def _port_model(kind: str, **kw):
    """The small port model with the flax params, on the CPU."""
    if kind == "afgsa":
        model, to_state = AFGSANet(**dict(AFGSA, **kw)), afgsa_state_from_flax
    else:
        model, to_state = MambaDenoiserNet(**dict(MAMBA, **kw)), mamba_state_from_flax
    model.load_state_dict(to_state(_flax_params(kind)))
    return model.eval()


def _inputs(seed: int, batch: int = BATCH):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0, 2, (batch, WINDOW, WINDOW, 3)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((batch, WINDOW, WINDOW, 7)).astype(np.float32)))


def _frame(seed, h, w):
    rng = np.random.default_rng(seed)
    return {"noisy": rng.uniform(0.05, 2.0, (h, w, 3)).astype(np.float32),
            "aux": rng.uniform(-1, 1, (h, w, 7)).astype(np.float32)}


def _export(model, out, **kw):
    kw = {"window": WINDOW, "batch_tiles": BATCH, "platforms": ("cpu",), **kw}
    return export_denoiser(model, out, **kw)


def _live(model, noisy, aux):
    with torch.no_grad():
        return model(noisy, aux)


# route → (model kwargs, the kernel op it exports, how many)
ROUTES = {
    "literal": (dict(use_kernels=True), "block_halo_attention", AFGSA["num_sa"]),
    "block_bf16": (dict(use_kernels=True, use_block_kernel=True, dtype=torch.bfloat16),
                   "transformer_block_fwd", AFGSA["num_sa"]),
    "film": (dict(use_kernels=True, use_block_kernel=True, use_film=True),
             "block_halo_attention", AFGSA["num_sa"]),
    "fold_qkv": (dict(use_kernels=True, fold_qkv=True, base_ch=128, enc_ch=16),
                 "block_halo_attention", AFGSA["num_sa"]),
}


class TestExportRoundTrip:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_artifact_matches_live_model(self, tmp_path, route):
        """The AFGSA routes: the artifact equals the live model to the bit
        and holds one kernel op per block."""
        kw, op, count = ROUTES[route]
        model = AFGSANet(**dict(AFGSA, **kw), generator=torch.Generator().manual_seed(0)).eval()
        out = _export(model, tmp_path / "art")
        assert (out / MODULE_FILE).exists()
        apply_fn, manifest = load_exported(out, device="cpu")
        assert manifest["kernel_ops"] == {op: count}
        assert manifest["window"] == WINDOW and manifest["batch_tiles"] == BATCH
        noisy, aux = _inputs(0)
        assert torch.equal(apply_fn(noisy, aux), _live(model, noisy, aux))

    @pytest.mark.parametrize("fused", [True, False])
    def test_mamba_artifact(self, tmp_path, fused):
        model = _port_model("mamba", use_kernels=True, use_megakernel=fused)
        out = _export(model, tmp_path / "art", model_name="mamba")
        apply_fn, manifest = load_exported(out, device="cpu")
        assert manifest["model_name"] == "mamba"
        assert manifest["kernel_ops"] == ({"fused_mamba_chain": MAMBA["num_blocks"]}
                                          if fused else {})
        noisy, aux = _inputs(1)
        assert torch.equal(apply_fn(noisy, aux), _live(model, noisy, aux))

    def test_multi_platform_portable_rebuild(self, tmp_path):
        """`cpu,cuda`: the plain route, no kernel op in the graph; a
        kernel-route model is refused for it."""
        with pytest.raises(ValueError, match="plain route"):
            _export(_port_model("afgsa", use_kernels=True), tmp_path / "kernels",
                    platforms=("cpu", "cuda"))
        model = _port_model("afgsa")
        out = _export(model, tmp_path / "art", platforms=("cpu", "cuda"))
        apply_fn, manifest = load_exported(out, device="cpu")
        assert sorted(manifest["platforms"]) == ["cpu", "cuda"]
        assert manifest["kernel_ops"] == {}
        noisy, aux = _inputs(2)
        assert torch.equal(apply_fn(noisy, aux), _live(model, noisy, aux))

    def test_route_without_an_op_fails_the_export(self, tmp_path):
        """The literal Mamba route's fused conv (`use_pallas`, K9) launches
        outside any op: the export fails and names it."""
        model = MambaDenoiserNet(**dict(MAMBA, d_state=64), use_kernels=True,
                                 use_pallas=True).eval()
        assert model.blocks[0].mamba.fused_conv_route(WINDOW * WINDOW)
        with pytest.raises(RuntimeError, match="fused_causal_conv1d_silu.*torch.export"):
            _export(model, tmp_path / "art")
        assert not (tmp_path / "art" / MODULE_FILE).exists()


@functools.lru_cache(maxsize=None)
def _jax_artifact_output(kind: str, tmp: str) -> np.ndarray:
    jmodel = _jax_model(kind)
    out = jexport_denoiser(jmodel, {"params": _flax_params(kind)}, Path(tmp) / kind,
                           window=WINDOW, batch_tiles=BATCH, platforms=("cpu",))
    apply_fn, _ = jload_exported(out)
    noisy, aux = _inputs(3)
    return np.asarray(apply_fn(jnp.asarray(noisy.numpy()), jnp.asarray(aux.numpy())))


@pytest.mark.parametrize("kind,kw", [
    ("afgsa", {}), ("afgsa", dict(use_kernels=True)),
    ("mamba", {}), ("mamba", dict(use_kernels=True, use_megakernel=True)),
], ids=["afgsa-plain", "afgsa-kernel-ops", "mamba-plain", "mamba-kernel-ops"])
def test_fp32_artifact_matches_jax_artifact(tmp_path_factory, kind, kw):
    want = _jax_artifact_output(kind, str(tmp_path_factory.getbasetemp()))
    out = _export(_port_model(kind, **kw), tmp_path_factory.mktemp("art"))
    apply_fn, _ = load_exported(out, device="cpu")
    got = apply_fn(*_inputs(3)).numpy()
    assert got.shape == want.shape == (BATCH, WINDOW, WINDOW, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_block_route_bf16_artifact_close_to_jax_fp32(tmp_path_factory):
    """bf16 activations through two blocks, as
    test_torch_port_afgsa.py::test_block_route_bf16_close_to_jax_fp32."""
    want = _jax_artifact_output("afgsa", str(tmp_path_factory.getbasetemp()))
    model = _port_model("afgsa", use_kernels=True, use_block_kernel=True, dtype=torch.bfloat16)
    out = _export(model, tmp_path_factory.mktemp("art"))
    apply_fn, manifest = load_exported(out, device="cpu")
    assert manifest["kernel_ops"] == {"transformer_block_fwd": AFGSA["num_sa"]}
    got = apply_fn(*_inputs(3)).numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_export_tool_rejects_unknown_option():
    """Mistyped export.* overrides must error, not silently no-op."""
    with pytest.raises(SystemExit, match="unknown export option"):
        export_model.main(["export.windw=256"])


def test_export_tool_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="export.platforms=cpu"):
        export_model.main(["-cn", "prod", "trainer.model_path=g.pt", "export.out_dir=art"])


def test_export_tool_end_to_end(tmp_path, tmp_cwd):
    """A `save_params` file through the CLI: a CPU artifact with the kernel
    ops, and the portable `cpu,cuda` artifact of the plain route."""
    model = _port_model("afgsa")
    checkpoints.save_params(tmp_path / "g.pt", model)
    base = ["-cn", "prod", *AFGSA_CFG, f"trainer.model_path={tmp_path / 'g.pt'}",
            f"export.window={WINDOW}", f"export.batch_tiles={BATCH}"]
    cpu = export_model.main(base + [f"export.out_dir={tmp_path / 'cpu'}",
                                    "export.platforms=cpu"])
    portable = export_model.main(base + [f"export.out_dir={tmp_path / 'portable'}",
                                         "export.platforms=cpu,cuda"])
    man_cpu, man_portable = load_manifest(cpu), load_manifest(portable)
    assert man_cpu["kernel_ops"] == {"block_halo_attention": AFGSA["num_sa"]}
    assert man_cpu["config_name"] == "prod" and man_cpu["model_name"] == "afgsa"
    assert man_portable["kernel_ops"] == {} and man_portable["platforms"] == ["cpu", "cuda"]
    noisy, aux = _inputs(4)
    want = _live(model, noisy, aux)
    for out in (cpu, portable):
        apply_fn, _ = load_exported(out, device="cpu")
        assert torch.equal(apply_fn(noisy, aux), want)


class TestManifest:
    def test_fields(self, tmp_path):
        out = _export(_port_model("afgsa"), tmp_path / "art", extra_meta={"config_name": "ci"})
        manifest = load_manifest(out)
        assert manifest["artifact_version"] == ARTIFACT_VERSION
        assert manifest["inputs"]["noisy"]["shape"] == [BATCH, WINDOW, WINDOW, 3]
        assert manifest["inputs"]["aux"]["shape"] == [BATCH, WINDOW, WINDOW, 7]
        assert manifest["platforms"] == ["cpu"] and manifest["traced_on"] == "cpu"
        assert manifest["config_name"] == "ci"
        assert manifest["torch_version"] == torch.__version__
        assert manifest["model_name"] == "AFGSANet"

    def test_version_gate(self, tmp_path):
        out = _export(_port_model("afgsa"), tmp_path / "art")
        path = out / MANIFEST_FILE
        manifest = json.loads(path.read_text())
        manifest["artifact_version"] = ARTIFACT_VERSION + 1
        path.write_text(json.dumps(manifest))
        with pytest.raises(ValueError, match="artifact version"):
            load_exported(out, device="cpu")

    def test_platform_mismatch(self, tmp_path):
        """A CPU artifact refuses the card, a CUDA artifact the CPU."""
        out = _export(_port_model("afgsa"), tmp_path / "art")
        with pytest.raises(ValueError, match="lowered for"):
            load_exported(out, device="cuda")
        path = out / MANIFEST_FILE
        manifest = json.loads(path.read_text())
        manifest["platforms"] = ["cuda"]
        path.write_text(json.dumps(manifest))
        with pytest.raises(ValueError, match="lowered for"):
            load_exported(out, device="cpu")

    def test_load_exported_defaults_to_cuda(self):
        import inspect

        assert inspect.signature(load_exported).parameters["device"].default == "cuda"
        assert inspect.signature(export_denoiser).parameters["platforms"].default == ("cuda",)


class TestInferenceIntegration:
    def test_denoise_frame_through_artifact(self, tmp_path):
        """The loaded artifact drops into `denoise_frame` and gives the live
        model's frame to the bit."""
        model = _port_model("afgsa", use_kernels=True)
        apply_fn, _ = load_exported(_export(model, tmp_path / "art"), device="cpu")
        data = _frame(2, 24, 40)
        got = denoise_frame(apply_fn, data, **TILES, device="cpu")
        want = denoise_frame(model, data, **TILES, device="cpu")
        np.testing.assert_array_equal(got, want)

    def test_fused_frame_through_artifact(self, tmp_path):
        model = _port_model("mamba", use_kernels=True, use_megakernel=True)
        apply_fn, _ = load_exported(_export(model, tmp_path / "art"), device="cpu")
        data = _frame(3, 24, 40)
        fused = make_fused_frame_apply(apply_fn, (24, 40), **TILES, device="cpu")
        got = denoise_frame_fused(fused, data, device="cpu")
        want = denoise_frame(apply_fn, data, **TILES, device="cpu")
        np.testing.assert_array_equal(got, want)

    def test_run_inference_from_export(self, tmp_path, tmp_cwd):
        """`evaluation.txt` of the artifact equals the live model's; the CLI
        serves the artifact with no `trainer.model_path`, its window
        setting the tile (margin 8 → tile 16)."""
        checkpoints.save_params(tmp_path / "g.pt", _port_model("afgsa"))
        images = tmp_path / "images"
        generate_dataset(images, scenes=["fftle0_0"], height=24, width=40)
        art = export_model.main(["-cn", "prod", *AFGSA_CFG,
                                 f"trainer.model_path={tmp_path / 'g.pt'}",
                                 f"export.out_dir={tmp_path / 'art'}", "export.platforms=cpu",
                                 f"export.window={WINDOW}", f"export.batch_tiles={BATCH}"])
        cfg = ConfigRegistry.create_config(compose(
            "prod", [*AFGSA_CFG, f"trainer.model_path={tmp_path / 'g.pt'}"],
            resolve_interpolations=False))
        live = run_inference(cfg, str(images), str(tmp_path / "live"), **TILES, device="cpu")
        served = run_inference(cfg, str(images), str(tmp_path / "served"), tile=64, margin=8,
                               batch_tiles=8, from_export=str(art), device="cpu")
        assert served == live
        name = "fftle0_0_32_evaluation.txt"
        text = (tmp_path / "live" / name).read_text()
        assert (tmp_path / "served" / name).read_text() == text
        main(["-cn", "prod", *AFGSA_CFG, f"inference.from_export={art}",
              f"inference.images_dir={images}", f"inference.out_dir={tmp_path / 'cli'}",
              "inference.margin=8", "inference.device=cpu"])
        assert (tmp_path / "cli" / name).read_text() == text


_SERVE_ALONE = """
import sys
import numpy as np
import torch
from pixel_heal_thyself_tpu_torch.serving import load_exported

apply_fn, manifest = load_exported(sys.argv[1], device="cpu")
rng = np.random.default_rng(0)
b, w = manifest["batch_tiles"], manifest["window"]
noisy = torch.from_numpy(rng.uniform(0, 2, (b, w, w, 3)).astype(np.float32))
aux = torch.from_numpy(rng.standard_normal((b, w, w, 7)).astype(np.float32))
with torch.inference_mode():
    out = apply_fn(noisy, aux)
models = sorted(m for m in sys.modules if m.startswith("pixel_heal_thyself_tpu_torch.models"))
np.save(sys.argv[2], out.numpy())
print("MODELS", models)
"""


def test_artifact_serves_in_a_fresh_process_without_model_classes(tmp_path):
    model = _port_model("afgsa", use_kernels=True)
    out = _export(model, tmp_path / "art")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_ALONE, str(out), str(tmp_path / "out.npy")],
        capture_output=True, text=True, cwd=root, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "MODELS []" in proc.stdout
    rng = np.random.default_rng(0)
    noisy = torch.from_numpy(rng.uniform(0, 2, (BATCH, WINDOW, WINDOW, 3)).astype(np.float32))
    aux = torch.from_numpy(rng.standard_normal((BATCH, WINDOW, WINDOW, 7)).astype(np.float32))
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), _live(model, noisy, aux).numpy())
