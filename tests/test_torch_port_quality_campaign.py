"""The port's quality campaign (`tools/quality_campaign.py`) against the JAX
package's `tools/r5_quality_campaign.sh`, on the CPU.

- Leg 1: the script's own `generate_dataset` calls (its Python block run
  with the JAX function recording them) are the port's, argument for
  argument; at 2 scenes of 64² a directory the port's four directories
  equal the JAX function's byte for byte.
- Legs 2a, 2b and 3: the port's composed config of each training leg
  equals the JAX `compose` of the script's command line, up to `paths`.
- The campaign end to end through its CLI with `--device cpu`, legs 1, 2a
  and 4 then 1, 2b, 3 and 4 (the summary holds all three legs) at
  narrow widths (the `-cn ci` run's, as tests/test_torch_port_trainer.py's
  TINY), 1 epoch, 8 patches an image, on 64² datasets that leg 1 keeps;
  then leg 5, whose analysis tools (`tools/runs_analysis.py`,
  `tools/runs_inference_analysis.py`) parse every file it wrote with their
  own regexes.
- The summary's full-frame mean over round 5's per-scene files gives
  BASELINE.md's numbers.
- The diagnostic legs (`2a-d16`: the critic in bf16; `2a-abc`: the three
  arithmetic switches) each change their one thing, are held against
  2a's numbers, and leave the switches as they found them.

Torch is held to 2 threads, as in test_torch_port_trainer_cli.py.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import shlex
import shutil
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import pixel_heal_thyself_tpu.data.synthetic as jsynthetic  # noqa: E402
import pixel_heal_thyself_tpu_torch.data.synthetic as psynthetic  # noqa: E402
from pixel_heal_thyself_tpu.config import compose as jcompose  # noqa: E402
from pixel_heal_thyself_tpu.config.run_dirs import (  # noqa: E402
    register_run_dirs_resolver as jregister,
)
from pixel_heal_thyself_tpu_torch.config import compose as pcompose  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import (  # noqa: E402
    register_run_dirs_resolver as pregister,
)
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.tools import quality_campaign as qc  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "tools" / "r5_quality_campaign.sh"
R5 = REPO / "reports" / "r5_quality"
# narrow widths for the CPU, one list a generator's legs
NARROW = ["trainer.epochs=1", "data.patches.num_patches=8", "data.patches.patch_size=16",
          "trainer.batch_size=2", "trainer.precision=fp32", "model.feature_map_channels=16",
          "+model.enc_channels=16"]
NARROW_AFGSA = [*NARROW, "model.afgsa.self_attention.num_layers=1"]
NARROW_MAMBA = [*NARROW, "model.mamba.num_layers=1", "model.mamba.expansion=2",
                "model.mamba.headdim=8", "model.mamba.d_state=8"]


@pytest.fixture(autouse=True, scope="module")
def _determinism_restored():
    """A trainer sets torch's determinism switches and
    CUBLAS_WORKSPACE_CONFIG for its process (`trainer.deterministic`):
    restored when this file's tests end, so that the worker's next files
    run under torch's defaults."""
    import os
    from unittest import mock

    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import arithmetic, switches_now

    with arithmetic(switches_now()), mock.patch.dict(os.environ):
        yield


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_run_dirs():
    reset_run_dirs_cache()
    yield
    reset_run_dirs_cache()


def _script_python() -> str:
    text = SCRIPT.read_text()
    return text.split("python - <<'EOF'\n", 1)[1].split("\nEOF\n", 1)[0]


def _script_commands(module: str) -> list[list[str]]:
    """The script's `python -m <module>` command lines, continuations
    joined and split as the shell would ($ROOT kept)."""
    text = SCRIPT.read_text().replace("\\\n", " ")
    return [shlex.split(line.strip())[3:] for line in text.splitlines()
            if line.strip().startswith(f"python -m {module} ")]


def _record(monkeypatch, module) -> list[tuple]:
    calls = []
    monkeypatch.setattr(module, "generate_dataset",
                        lambda d, **kw: calls.append((str(d), kw)))
    return calls


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_leg1_calls_are_the_scripts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcalls = _record(monkeypatch, jsynthetic)
    exec(compile(_script_python(), str(SCRIPT), "exec"), {})
    pcalls = _record(monkeypatch, psynthetic)
    qc.make_datasets(".", log=lambda s: None)
    assert len(jcalls) == 4
    assert pcalls == [(str(Path(".", d)), kw) for d, kw in jcalls]


@pytest.mark.parametrize("channel", list(qc.CHANNELS))
def test_leg1_datasets_equal_jax(tmp_path, monkeypatch, channel):
    monkeypatch.chdir(tmp_path)
    jcalls = _record(monkeypatch, jsynthetic)
    exec(compile(_script_python(), str(SCRIPT), "exec"), {})
    monkeypatch.undo()
    wanted = [str(d) for d in qc.channel_dirs("", channel)]
    for d, kw in jcalls:
        if d in wanted:
            jsynthetic.generate_dataset(tmp_path / "jax" / d, **dict(
                kw, scenes=kw["scenes"][:2], height=64, width=64))
    qc.make_datasets(tmp_path / "port", channels=(channel,), size=64, n_scenes=2,
                     log=lambda s: None)
    jfiles, pfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(pfiles) == 8  # 2 directories × 2 scenes × (32 spp, 1024 spp)
    assert jfiles.keys() == pfiles.keys()
    assert all(jfiles[k] == pfiles[k] for k in jfiles)


def _tree_without_paths(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if k != "paths"}


@pytest.mark.parametrize("leg", qc.TRAINING, ids=lambda leg: leg.name)
def test_training_leg_config_equals_jax_compose(tmp_path, monkeypatch, leg):
    monkeypatch.chdir(tmp_path)
    jregister()
    pregister()
    script = [argv for argv in _script_commands("pixel_heal_thyself_tpu.train")
              if argv[1] == leg.config and argv[-1].endswith(f"/images_prod_synth_{leg.channel}")]
    assert len(script) == 1
    jargv = [a.replace("$ROOT", str(tmp_path)) for a in script[0]]
    assert jargv[0] == "-cn"
    want = jcompose(jargv[1], jargv[2:])
    pargv = qc.train_argv(leg, tmp_path, device="cpu")
    assert pargv[:2] == ["-cn", leg.config] and pargv[-2:] == ["--device", "cpu"]
    got = pcompose(pargv[1], pargv[2:-2])
    assert got["data"]["images"]["dir"] == want["data"]["images"]["dir"]
    assert _tree_without_paths(got) == _tree_without_paths(want)


@pytest.mark.parametrize("val,full,want", [(37.47, 37.30, (True, True)),
                                            (37.4701, 37.97, (False, True)),
                                            (36.80, 37.2999, (True, False))])
def test_summary_bands(tmp_path, val, full, want):
    (tmp_path / "legs").mkdir()
    rec = {"leg": "2a", "val_psnr": val, "full_frame_psnr": full}
    (tmp_path / "legs" / "2a.json").write_text(json.dumps(rec))
    got = qc.summary(tmp_path, card="c", device="cuda")
    assert (got["card"], got["device"]) == ("c", "cuda")
    leg = got["legs"]["2a"]
    assert (leg["val_psnr_in_band"], leg["full_frame_in_band"]) == want
    assert leg["reference"] == qc.REFERENCE["2a"]


def test_unknown_legs_and_missing_card_raise(tmp_path):
    with pytest.raises(ValueError, match="leg 5 runs alone"):
        qc.run(tmp_path, legs=("1", "5"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            qc.run(tmp_path, legs=("1",))
        assert not (tmp_path / "data").exists()


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_campaign_end_to_end_and_leg5_parse(tmp_path, capsys):
    pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    pytest.importorskip("cv2")
    root = tmp_path / "campaign"
    qc.make_datasets(root, size=64, n_scenes=2, log=lambda s: None)  # leg 1 keeps them
    qc.main(["--legs", "1,2a,4", "--root", str(root), "--device", "cpu", *NARROW_AFGSA])
    summary = qc.main(["--legs", "1,2b,3,4", "--root", str(root), "--device", "cpu",
                       *NARROW_MAMBA])
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(summary))
    assert summary["device"] == "cpu" and summary["card"] is None
    assert set(summary["legs"]) == {"2a", "2b", "3"}
    out = root / "reports" / "port_r5_quality"
    served = [*qc.TRAIN_SCENES[:2], *qc.HELDOUT_SCENES]
    for name, rec in summary["legs"].items():
        assert rec["epochs"] == 1 and math.isfinite(rec["val_psnr"])
        assert rec["reference"] == qc.REFERENCE[name]
        assert rec["val_psnr_in_band"] is False  # 1 epoch of a narrow model
        for suffix in ("train_loss.txt", "evaluation.txt"):
            text = (out / f"{rec['run']}_{suffix}").read_text()
            assert f"==> {out / rec['run']}_{suffix} <==" in printed
            assert text.splitlines()[-1] in printed
        if name in qc.SERVED:
            assert rec["served_scenes"] == 4 and set(rec["heldout_psnr"]) == set(qc.HELDOUT_SCENES)
            folder = out / rec["model"]
            assert sorted(p.name for p in folder.iterdir()) == sorted(
                f"{s}_32_evaluation.txt" for s in served)
            assert rec["full_frame_psnr"] == pytest.approx(qc.full_frame_mean(folder))
    # round 5's names: the Mamba re-run on the 0.75 channel is the second run
    assert [summary["legs"][n]["run"] for n in ("2a", "2b", "3")] == [
        "afgsa_p16_n8_r1.0_run000", "mamba_p16_n8_r0.5_run000", "mamba_p16_n8_r0.5_run001"]

    qc.main(["--legs", "5", "--root", str(root), "--baseline", str(R5), "--header", "H"])
    ra, ria = _tool("runs_analysis"), _tool("runs_inference_analysis")
    for rec in summary["legs"].values():
        assert [m[1] for m in ra.EVAL_RE.finditer(
            (out / f"{rec['run']}_evaluation.txt").read_text())] == ["1"]
        assert [m[1] for m in ra.LOSS_RE.finditer(
            (out / f"{rec['run']}_train_loss.txt").read_text())] == ["1"]
    scene_files = sorted(out.glob("*/*_32_evaluation.txt"))
    assert len(scene_files) == 8
    assert all(ria.process_evaluation_file(str(f)) for f in scene_files)
    rows = (out / "comparison" / "inference_data.csv").read_text().splitlines()
    assert len(rows) == 1 + 12 + 4 + 12 + 4  # r5 AFGSA, port AFGSA, r5 Mamba, port Mamba
    runs = (out / "training_analysis" / "runs_data.csv").read_text()
    for exp in ("r5_leg2a", "r5_leg2b", "r5_leg3", "port_leg2a", "port_leg2b", "port_leg3"):
        assert exp in runs
    report = (out / "report.md").read_text().splitlines()
    assert report[2] == "H"
    assert sum(bool(re.match(r"\| (2a|2b|3) \|", line)) for line in report) == 3


@pytest.mark.parametrize("folder,want", [("afgsa", 37.6693), ("afgsa_mega", 37.6039),
                                         ("mamba", 38.3803)])
def test_full_frame_mean_of_round5(folder, want):
    assert round(qc.full_frame_mean(R5 / folder), 4) == want
    assert len(qc.scene_metrics(R5 / folder)) == 12


def test_diagnostic_legs_change_one_thing_and_restore(tmp_path):
    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import switches_now

    bf16 = [o for o in NARROW_AFGSA if not o.startswith("trainer.precision")]
    before = switches_now()
    summary = qc.run(tmp_path, legs=("1", "2a-d16", "2a-abc"), overrides=bf16, device="cpu",
                     size=64, n_scenes=2, log=lambda s: None)
    assert switches_now() == before
    legs = summary["legs"]
    assert set(legs) == {"2a-d16", "2a-abc"}
    for rec in legs.values():
        assert rec["base"] == "2a" and rec["reference"] == qc.REFERENCE["2a"]
        assert rec["epochs"] == 1 and math.isfinite(rec["val_psnr"])
    # the trainer's bf16 arithmetic with its determinism settings
    trainer_bf16 = {**before, "tf32": True, "cudnn_deterministic": True,
                    "deterministic_algorithms": "warn_only"}
    assert legs["2a-d16"]["critic_dtype"] == "bfloat16"
    assert legs["2a-d16"]["arithmetic"] == trainer_bf16
    assert legs["2a-abc"]["critic_dtype"] == "float32"  # the trainer's critic
    assert legs["2a-abc"]["arithmetic"] == {"tf32": False, "bf16_reduced_reduction": False,
                                            "cudnn_deterministic": True,
                                            "deterministic_algorithms": "warn_only"}
    (d16,) = [leg for leg in qc.DIAGNOSTIC if leg.name == "2b-d16"]
    assert (d16.base, d16.critic_dtype, d16.arithmetic) == ("2b", torch.bfloat16, ())
    assert (d16.model, d16.config, d16.channel, d16.overrides) == \
        (qc.TRAINING[1].model, qc.TRAINING[1].config, qc.TRAINING[1].channel,
         qc.TRAINING[1].overrides)
    with pytest.raises(ValueError, match="diagnostic"):
        qc.run(tmp_path, legs=("2a-x",), device="cpu")


def test_seed_legs_change_only_the_seed_and_the_critic():
    """The seed list fixed before any seed leg ran, and each leg its base
    but for `seed=` and the critic's dtype."""
    assert qc.SEEDS == (990820, 990821, 990822)
    want = {f"2b-s{s}-{c}" for s in qc.SEEDS for c in ("d16", "d32")}
    want |= {f"2a-s{s}-{c}" for s in qc.SEEDS[:2] for c in ("d16", "d32")}
    assert {leg.name for leg in qc.SEED_LEGS} == want and len(qc.SEED_LEGS) == 10
    base = {leg.name: leg for leg in qc.TRAINING}
    for leg in qc.SEED_LEGS:
        b = base[leg.base]
        seed = int(leg.name.split("-s")[1].split("-")[0])
        assert (leg.model, leg.config, leg.channel, leg.arithmetic) == \
            (b.model, b.config, b.channel, ())
        assert leg.overrides == b.overrides + (f"seed={seed}",)
        assert leg.critic_dtype == {"d16": torch.bfloat16, "d32": torch.float32}[
            leg.name[-3:]]


def test_seed_legs_sample_their_own_store(tmp_path):
    """A seed leg's command line composes the base leg's config but for
    the seed and its own patch store; the datasets are the base's."""
    pregister()
    (leg,) = [leg for leg in qc.SEED_LEGS if leg.name == "2b-s990821-d32"]
    base = qc.TRAINING[1]
    cfgs = []
    for spec in (base, leg):
        argv = qc.train_argv(spec, tmp_path, device="cpu")
        assert argv[-2:] == ["--device", "cpu"]
        cfgs.append(pcompose(argv[1], argv[2:-2] + [f"paths.output_dir={tmp_path}"]))
    assert cfgs[1]["seed"] == 990821 and cfgs[0]["seed"] == 990819
    store = Path(cfgs[1]["data"]["patches"]["dir"])
    assert store.parent == Path(cfgs[0]["data"]["patches"]["dir"]).parent
    assert store.name == Path(cfgs[0]["data"]["patches"]["dir"]).name + "_seed990821"
    for cfg in cfgs:
        cfg["seed"] = 0
        cfg["data"]["patches"]["dir"] = None
    assert cfgs[0] == cfgs[1]


@pytest.mark.parametrize("d_loss, val, want", [
    ((0.0329, 0.0113, 0.0341), (31.5304, 37.4999, 37.6807), "weak critic"),      # (e)
    ((0.0390, -0.0075, 0.0012), (32.0295, 37.2943, 37.3424), "neither"),         # (d)
    ((0.0402, 0.0097, 0.0031), (32.2878, 37.6985, 37.5641), "weak critic"),      # 2a-abc
    ((0.0345, -0.0103, 0.0011), (31.7214, 37.6931, 37.4631), "reference-like"),  # 2a-d32
    ((0.0239, -0.0170, 0.0002), (31.8894, 37.5451, 37.2630), "reference-like")])  # round 5
def test_critic_class_reads_pr19s_legs_as_pr19(d_loss, val, want):
    assert qc.critic_class(d_loss, val) == want


def test_spread_of_the_recorded_seed_legs(tmp_path):
    """`--legs spread` over the recorded seed legs and seed 990819's
    records gives the recorded `spread.json`: each critic's four seeds,
    their statistics and Welch's test as scipy computes them, and the
    band verdicts of `summary` unchanged in `report.md`."""
    from scipy import stats

    seeds = REPO / "reports" / "port_r5_quality" / "seeds"
    shutil.copytree(seeds / "legs", tmp_path / "legs")
    got = qc.spread(tmp_path, REPO / "reports" / "port_r5_quality", log=lambda _: None)
    assert json.loads(json.dumps(got)) == json.loads((seeds / "spread.json").read_text())
    assert len(list((tmp_path / "legs").glob("*.json"))) == len(qc.SEED_LEGS)
    means = {}
    for critic, row in got["2b"].items():
        assert sorted(row["seeds"]) == ["990819", *map(str, qc.SEEDS)]
        means[critic] = [v["full_frame_psnr"] for v in row["seeds"].values()]
        assert row["mean"] == pytest.approx(sum(means[critic]) / 4)
    want = stats.ttest_ind(means["float32"], means["bfloat16"], equal_var=False)
    assert got["welch"]["p"] == pytest.approx(want.pvalue)
    for critic in ("float32", "bfloat16"):
        assert sorted(got["2a"][critic]) == ["990819", *map(str, qc.SEEDS[:2])]
    report = (tmp_path / "report.md").read_text()
    for name, rec in qc.summary(tmp_path)["legs"].items():
        row = next(line for line in report.splitlines() if line.startswith(f"| {name} |"))
        assert f"| {rec['val_psnr_in_band']} |" in row


def _leg_2a12(out: Path, seed: int, critic: str, val: float, full: float) -> None:
    """A synthetic 12-epoch 2a seed leg's record in `out/legs/`."""
    name = f"2a-s{seed}-{'d16' if critic == 'bfloat16' else 'd32'}"
    rec = {"leg": name, "model": "afgsa", "config": "prod", "channel": "clean05",
           "run": "afgsa_p128_n400_r1.0_run000", "epochs": 12, "base": "2a", "seed": seed,
           "critic_dtype": critic, "val_psnr": val, "val_1_ssim": 0.04,
           "d_loss": [0.03] * 12, "val_psnr_by_epoch": [val] * 12, "full_frame_psnr": full}
    (out / "legs").mkdir(parents=True, exist_ok=True)
    (out / "legs" / f"{name}.json").write_text(json.dumps(rec))


@pytest.mark.parametrize("bf16, want", [
    (((37.10, 37.60), (37.40, 37.90)), "the run's dtype"),  # both bf16 legs in both bands
    (((37.10, 37.60), (38.05, 37.90)), "float32"),  # 990821's validation above its band
    (((37.10, 37.60), (37.40, 38.00)), "float32"),  # 990821's full frame above its band
])
def test_spread_reads_12_epoch_2a_legs(tmp_path, bf16, want):
    """`spread` over synthetic 12-epoch 2a legs at seeds 990820 and 990821
    with seed 990819's recorded 12-epoch runs (`SEED_990819_2A12`, both
    before the determinism settings): each critic's three
    seeds, their statistics and round 5's z, Welch's test as scipy computes
    it, and the rule fixed before the legs ran."""
    import statistics

    from scipy import stats

    f32 = ((37.20, 37.70), (37.30, 37.50))
    for seed, (val, full) in zip(qc.SEEDS[:2], bf16):
        _leg_2a12(tmp_path, seed, "bfloat16", val, full)
    for seed, (val, full) in zip(qc.SEEDS[:2], f32):
        _leg_2a12(tmp_path, seed, "float32", val, full)
    got = qc.spread(tmp_path, REPO / "reports" / "port_r5_quality", log=lambda _: None)
    assert got["2b"] == {} and got["2a"] == {}  # no 2b or 3-epoch legs: none joined
    r = got["2a_12"]
    recorded = {"bfloat16": (37.832, 38.28939166666667), "float32": (37.1841, 37.662866666666666)}
    values = {}
    for critic, new in (("bfloat16", bf16), ("float32", f32)):
        row = r["critics"][critic]
        assert sorted(row["seeds"]) == ["990819", *map(str, qc.SEEDS[:2])]
        assert row["seeds"]["990819"]["before_repair"]
        assert not any(row["seeds"][str(s)]["before_repair"] for s in qc.SEEDS[:2])
        values[critic] = [recorded[critic], *new]
        for i, key in enumerate(("val_psnr", "full_frame_psnr")):
            v = [x[i] for x in values[critic]]
            mean, sd = statistics.mean(v), statistics.stdev(v)
            assert row[key]["mean"] == pytest.approx(mean) and row[key]["sd"] == pytest.approx(sd)
            assert row[key]["round5_z"] == pytest.approx((r["round5"][key] - mean) / sd)
            band = qc.REFERENCE["2a"]["val_band" if i == 0 else "full_frame_band"]
            for s, x in zip(["990819", *map(str, qc.SEEDS[:2])], v):
                assert row["seeds"][s][f"{key}_in_band"] is (band[0] <= x <= band[1])
    for i, key in enumerate(("val_psnr", "full_frame_psnr")):
        t = stats.ttest_ind([x[i] for x in values["float32"]], [x[i] for x in values["bfloat16"]],
                            equal_var=False)
        assert r["welch"][key]["p"] == pytest.approx(t.pvalue)
    assert r["round5"] == {"val_psnr": pytest.approx(37.13385),
                           "full_frame_psnr": pytest.approx(37.6366)}
    assert r["rule"] == {"bf16_legs": ["990820", "990821"], "complete": True, "critic": want}
    report = (tmp_path / "report.md").read_text()
    assert f"the critic: {want}" in report
    assert "990819* 37.8320 / 38.2894" in report


def test_spread_leaves_a_half_done_rule_undecided(tmp_path):
    _leg_2a12(tmp_path, qc.SEEDS[0], "bfloat16", 37.1, 37.6)
    got = qc.spread(tmp_path, REPO / "reports" / "port_r5_quality", log=lambda _: None)
    assert got["2a_12"]["rule"] == {"bf16_legs": ["990820"], "complete": False,
                                    "critic": "undecided"}
