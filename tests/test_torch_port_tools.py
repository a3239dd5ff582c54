"""The port's measuring tools against the JAX package's, on the CPU.

- `tools/flops_train_step.py`: at narrow widths its FlopCounterMode counts
  of the G forward and G forward + backward lie within [0.88, 1.00] of the
  JAX tool's XLA `cost_analysis()` counts for both generators (XLA also
  counts elementwise work; FlopCounterMode only products and
  convolutions), and the full step's within [0.80, 1.05]. On the CPU the
  kernel route's G forward counts what the plain route's does, op for op;
  its backward recomputes the attention / chunk products the way the
  hand kernels do, so only its `bmm` count is larger.
- `tools/bench_inference.py`: `run` with a narrow AFGSANet and
  MambaDenoiserNet (one flax param tree carried across) on a 40 × 72
  frame, three geometries of one 32² window: its frames equal the JAX
  `denoise_frame` at 1e-4 of the largest output; the pipelined, sync and
  fused dispatch give the same bits; its seam PSNR is the JAX tool's
  `psnr` of the same arrays.
- `tools/bench_serving.py`: the exported and live frames equal to the bit,
  and the `pht::` ops of the live forward all in the artifact.
- `tools/bench_pipeline.py`: every mode runs 2 steps of a narrow step, the
  modes give the same loss sequence from the same batches, and the packed
  batch of `upload_fused` unpacks to the three-tensor batch.

Torch is held to 2 threads, as in test_torch_port_trainer_cli.py.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.config import LossesConfig as JLossesConfig  # noqa: E402
from pixel_heal_thyself_tpu.inference import denoise_frame as jdenoise_frame  # noqa: E402
from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.models.mamba import MambaDenoiserNet as JMamba  # noqa: E402
from pixel_heal_thyself_tpu.training import train_step as jtrain_step  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    mamba_state_from_flax,
)
from pixel_heal_thyself_tpu_torch.tools import (  # noqa: E402
    bench_inference,
    bench_pipeline,
    bench_serving,
    flops_train_step,
)

REPO = Path(__file__).resolve().parent.parent
# the probe sizes: AFGSA base 32, 2 blocks; Mamba as tests/test_torch_port_mamba_model.py
NETS = {
    "afgsa": (AFGSANet, JAFGSANet, dict(base_ch=32, enc_ch=32, num_sa=2, num_gcp=0),
              dict(use_block_kernel=True)),
    "mamba": (MambaDenoiserNet, JMamba, dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16,
                                             headdim=32, expansion=4, num_gcp=0),
              dict(use_megakernel=True)),
}
FLOP_BATCH, FLOP_PATCH = 2, 32
WINDOW_GEOMS = ((16, 8), (24, 4), (28, 2))  # each a 32² window, as the tool's keep 128²
FRAME = (40, 72)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: under the tier-1 command's six workers a
    thread per core in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port(kind: str, kernels: bool, **kw):
    net, _, small, route = NETS[kind]
    return net(**small, padding_mode="replicate", use_kernels=kernels,
               **{k: kernels for k in route}, generator=torch.Generator().manual_seed(0), **kw)


def _critic(seed: int = 1):
    return DiscriminatorVGG(in_nc=3, base_nf=64, input_size=FLOP_PATCH,
                            generator=torch.Generator().manual_seed(seed))


@functools.lru_cache(maxsize=None)
def _xla_flops(kind: str) -> dict:
    """The JAX tool's three XLA counts (`tools/flops_train_step.py:72-98`)
    at the probe size, in FLOP."""
    _, jnet, small, _ = NETS[kind]
    g, d = jnet(**small), JDiscriminatorVGG(input_size=FLOP_PATCH)
    tx = jtrain_step.make_optimizer(1e-4, [2], 0.5, steps_per_epoch=100)
    b, p = FLOP_BATCH, FLOP_PATCH
    noisy0, aux0 = jnp.zeros((b, p, p, 3)), jnp.zeros((b, p, p, 7))
    # abstract states (shapes and dtypes): XLA's cost needs no values, and
    # an eager init would run every op of both models
    gstate = jax.eval_shape(
        lambda: jtrain_step.init_train_state(g, tx, jax.random.PRNGKey(0), noisy0, aux0))
    dstate = jax.eval_shape(
        lambda: jtrain_step.init_train_state(d, tx, jax.random.PRNGKey(1), noisy0))
    step = jtrain_step.make_train_step(g, d, JLossesConfig(), False, tx, tx)

    def cost(fn, *a):
        return jax.jit(fn).lower(*a).compile().cost_analysis()["flops"]

    def g_fwd_bwd(params, noisy, aux, gt):
        return jax.grad(lambda pp: jnp.mean(jnp.abs(g.apply({"params": pp}, noisy, aux) - gt)))(
            params)

    return {"full": cost(step, gstate, dstate, {"noisy": noisy0, "gt": noisy0, "aux": aux0},
                         jax.random.PRNGKey(7)),
            "fwd": cost(lambda pp, n, a: g.apply({"params": pp}, n, a), gstate.params, noisy0,
                        aux0),
            "fwd_bwd": cost(g_fwd_bwd, gstate.params, noisy0, aux0, noisy0)}


@pytest.mark.parametrize("kind", ["afgsa", "mamba"])
def test_flop_counts_against_the_jax_tool(kind):
    got = flops_train_step.run(_port(kind, False).train(), _critic().train(), FLOP_BATCH,
                               FLOP_PATCH, device="cpu")
    want = _xla_flops(kind)
    per = FLOP_BATCH * 1e12
    ratios = {k: got[f"{name}_tflop_per_sample"] * per / want[k]
              for k, name in (("fwd", "g_fwd"), ("fwd_bwd", "g_fwd_bwd"), ("full", "full_step"))}
    print(f"{kind}: FlopCounterMode / XLA cost_analysis {ratios}")
    assert 0.88 <= ratios["fwd"] <= 1.0 and 0.88 <= ratios["fwd_bwd"] <= 1.0
    assert 0.80 <= ratios["full"] <= 1.05


def _per_op(fn) -> dict[str, int]:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    counter.mod_tracker = flops_train_step._GlobalOnly()
    with counter:
        fn()
    return {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}


@pytest.mark.parametrize("kind", ["afgsa", "mamba"])
def test_kernel_route_counts_the_plain_route(kind):
    """The tool counts the plain route; on the CPU the kernel route's
    wrappers run their plain versions and count the same forward, op for
    op. Their backward recomputes the attention logits / chunk products
    (as K4 and K8 do), which adds `bmm` work and nothing else."""
    noisy, aux = torch.zeros(FLOP_BATCH, FLOP_PATCH, FLOP_PATCH, 3), torch.zeros(
        FLOP_BATCH, FLOP_PATCH, FLOP_PATCH, 7)
    counts = {}
    for kernels in (False, True):
        g = _port(kind, kernels).train()
        params = [p for p in g.parameters() if p.requires_grad]
        fwd = _per_op(lambda: g(noisy, aux).detach())
        bwd = _per_op(lambda: torch.autograd.grad(g(noisy, aux).abs().mean(), params,
                                                  allow_unused=True))
        counts[kernels] = fwd, bwd
    assert counts[True][0] == counts[False][0]
    plain, kern = counts[False][1], counts[True][1]
    assert {k: v for k, v in kern.items() if k != "aten.bmm"} == {
        k: v for k, v in plain.items() if k != "aten.bmm"}
    assert kern["aten.bmm"] > plain["aten.bmm"]


def test_flop_share():
    assert flops_train_step.flop_share(0.989, 1000.0) == pytest.approx(1.0)
    assert flops_train_step.flop_share(0.1, 50.0) == pytest.approx(0.1 * 50 / 989)


@functools.lru_cache(maxsize=None)
def _flax_params(kind: str) -> dict:
    _, jnet, small, _ = NETS[kind]
    shapes = jax.eval_shape(jnet(**small).init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 32, 32, 7)))["params"]
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "A_log":
            return rng.uniform(0.0, 1.5, leaf.shape).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-4.0, -1.0, leaf.shape).astype(np.float32)
        if name in ("scale", "weight", "D"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name.startswith("rel_"):
            return rng.standard_normal(leaf.shape).astype(np.float32)
        fan = float(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 10.0
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _served(kind: str):
    """The narrow generator of `kind` on its kernel route with the flax
    params, and the JAX model's jitted apply."""
    params = _flax_params(kind)
    model = _port(kind, True).eval()
    model.load_state_dict((afgsa_state_from_flax if kind == "afgsa" else
                           mamba_state_from_flax)(params))
    jmodel = NETS[kind][1](**NETS[kind][2], padding_mode="replicate")
    return model, jax.jit(lambda n, a: jmodel.apply({"params": params}, n, a))


@pytest.mark.parametrize("kind", ["afgsa", "mamba"])
def test_bench_inference_frames_match_jax(kind):
    model, japply = _served(kind)
    frames = {}
    for variant in bench_inference.VARIANTS:
        results, frames[variant] = bench_inference.run(
            model, *FRAME, iters=1, variant=variant, geometries=WINDOW_GEOMS, device="cpu",
            log=lambda s: None)
        assert [(r["tile"], r["margin"]) for r in results] == list(WINDOW_GEOMS)
        assert all(r["sec_per_frame"] > 0 and r["mpix_per_sec"] > 0 for r in results)
    for geom in WINDOW_GEOMS:
        want = frames["pipelined"][geom]
        np.testing.assert_array_equal(frames["sync"][geom], want)
        np.testing.assert_array_equal(frames["fused"][geom], want)
    data = bench_inference.make_frame(1, *FRAME)
    psnr = _jax_tool("bench_inference").psnr
    for tile, margin in WINDOW_GEOMS:
        with jax.default_matmul_precision("highest"):
            ref = jdenoise_frame(japply, data, tile=tile, margin=margin, batch_tiles=8)
        got = frames["pipelined"][(tile, margin)]
        assert got.shape == ref.shape == (*FRAME, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    m32 = frames["pipelined"][WINDOW_GEOMS[0]]
    seams = [r["consistency_psnr_vs_m32"] for r in results]
    assert seams[0] is None
    for seam, geom in zip(seams[1:], WINDOW_GEOMS[1:]):
        assert seam == psnr(frames["fused"][geom], m32)


def test_bench_inference_refuses_sync_with_fused():
    with pytest.raises(SystemExit):
        bench_inference.main(["--sync", "--fused", "--device", "cpu"])


def test_bench_serving_artifact_equals_live(tmp_path):
    model = AFGSANet(base_ch=16, enc_ch=16, num_sa=1, num_heads=2, num_gcp=0,
                     padding_mode="replicate", use_kernels=True, use_block_kernel=True,
                     generator=torch.Generator().manual_seed(0)).eval()
    result, frames = bench_serving.run(model, str(tmp_path / "art"), frames=1, height=40,
                                       width=72, device="cpu", log=lambda s: None)
    np.testing.assert_array_equal(frames["exported"], frames["live"])
    assert result["max_abs_delta"] == 0.0
    # (this narrow fp32 model takes the literal route: K1's op once a block)
    assert result["pht_ops_in_live_forward"] == result["pht_ops_in_artifact"] == {
        "block_halo_attention": 1}
    assert result["live_ops_all_in_artifact"] and result["platforms"] == ["cpu"]
    assert result["artifact_bytes"] > 0 and result["exported_vs_live"] > 0
    assert result["geometry"] == "40x72 tile64 margin32"


@pytest.fixture(scope="module")
def pipeline_runs():
    torch.set_num_threads(2)
    g = _port("afgsa", True).train()
    d = DiscriminatorVGG(in_nc=3, base_nf=8, input_size=FLOP_PATCH,
                         generator=torch.Generator().manual_seed(1)).train()
    batches = bench_pipeline.host_batches(2, FLOP_BATCH, FLOP_PATCH, seed=3)
    probed = []
    runs = bench_pipeline.run(g, d, batches, "cpu", log=lambda s: None,
                              probe=lambda mode: _record(probed, mode))
    return runs, probed


@contextlib.contextmanager
def _record(probed: list, mode: str):
    probed.append(mode)
    yield


@pytest.mark.parametrize("mode", bench_pipeline.MODES)
def test_bench_pipeline_modes_compute_the_same_steps(pipeline_runs, mode):
    runs, probed = pipeline_runs
    assert probed == list(bench_pipeline.MODES)
    losses = runs[mode]["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all() and runs[mode]["patches_per_sec"] > 0
    assert losses == runs["resident"]["losses"]


def test_bench_pipeline_unpack_equals_the_batch():
    (batch,) = bench_pipeline.host_batches(1, 2, 8, seed=5)
    got = bench_pipeline.unpack(torch.from_numpy(bench_pipeline.pack(batch)))
    assert list(got) == list(bench_pipeline.KEYS)
    for key in bench_pipeline.KEYS:
        assert got[key].is_contiguous()
        np.testing.assert_array_equal(got[key].numpy(), batch[key])
