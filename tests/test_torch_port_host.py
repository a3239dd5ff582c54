"""The port's copies of the JAX package's host modules against the originals.

The port keeps its own config layer (and YAML tree), curve-order enum,
EXR codec, preprocessing, synthetic scenes and metrics so that it imports nothing of
the JAX package. These tests hold each copy equal to its original: the
same composed config for every `-cn` × model, byte-identical EXR files,
equal arrays and scores.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import pytest

from pixel_heal_thyself_tpu import config as jconfig
from pixel_heal_thyself_tpu import metrics as jmetrics
from pixel_heal_thyself_tpu.data import exr as jexr
from pixel_heal_thyself_tpu.data import preprocessing as jprep
from pixel_heal_thyself_tpu.data import synthetic as jsyn
from pixel_heal_thyself_tpu.ops import curves as jcurves
from pixel_heal_thyself_tpu_torch import config, metrics
from pixel_heal_thyself_tpu_torch.data import exr, preprocessing, synthetic
from pixel_heal_thyself_tpu_torch.ops import curves


def _plain(obj):
    """A Config as nested builtins: dataclasses by class name and fields,
    enums by class name and value (the two packages' classes differ)."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


@pytest.mark.parametrize("model", ["afgsa", "mamba"])
@pytest.mark.parametrize("name", ["ci", "dev", "stag", "prod"])
def test_compose_matches_jax(name, model):
    overrides = [f"model={model}"]
    tree = config.compose(name, overrides, resolve_interpolations=False)
    jtree = jconfig.compose(name, overrides, resolve_interpolations=False)
    assert tree == jtree
    got = config.ConfigRegistry.create_config(tree)
    want = jconfig.ConfigRegistry.create_config(jtree)
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("pixel_type", ["half", "float"])
def test_write_exr_groups_byte_identical(tmp_path, pixel_type):
    rng = np.random.default_rng(0)
    groups = {"default": rng.uniform(0, 4, (12, 20, 3)).astype(np.float32),
              "depth": rng.uniform(0, 1, (12, 20, 1)).astype(np.float32)}
    exr.write_exr_groups(tmp_path / "a.exr", groups, pixel_type=pixel_type)
    jexr.write_exr_groups(tmp_path / "b.exr", groups, pixel_type=pixel_type)
    assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()
    got, want = exr.read_exr(tmp_path / "a.exr"), jexr.read_exr(tmp_path / "b.exr")
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


def test_generate_dataset_and_preprocess_data_match(tmp_path):
    scenes = ["fftle0_0", "taccturb_1_0"]
    synthetic.generate_dataset(tmp_path / "a", scenes=scenes, height=24, width=40, seed=3)
    jsyn.generate_dataset(tmp_path / "b", scenes=scenes, height=24, width=40, seed=3)
    files = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*.exr"))
    assert files == sorted(p.relative_to(tmp_path / "b") for p in (tmp_path / "b").rglob("*.exr"))
    assert len(files) == 4
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()
    noisy, gt = tmp_path / "a/32spp/fftle0_0_32", tmp_path / "a/1024spp/fftle0_0_1024"
    for scale in (1.0, 0.5):
        got = preprocessing.preprocess_data(noisy, gt, scale=scale)
        want = jprep.preprocess_data(noisy, gt, scale=scale)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    x = np.random.default_rng(1).uniform(0, 3, (5, 7, 3)).astype(np.float32)
    for name in ("preprocess_specular", "postprocess_specular", "preprocess_normal",
                 "preprocess_depth"):
        np.testing.assert_array_equal(getattr(preprocessing, name)(x), getattr(jprep, name)(x))


def test_metrics_match():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 255, (2, 24, 24, 3))
    b = np.clip(a + rng.normal(0, 9, a.shape), 0, 255)
    for name in ("calculate_psnr", "calculate_ssim", "calculate_rmse"):
        for x, y in ((a, b), (a[0], b[0])):
            assert getattr(metrics, name)(x, y) == getattr(jmetrics, name)(x, y)


@pytest.mark.parametrize("order", ["raster", "hilbert", "zorder"])
def test_curve_order_matches(order):
    assert curves.CurveOrder(order) == jcurves.CurveOrder(order) == order
    assert [m.value for m in curves.CurveOrder] == [m.value for m in jcurves.CurveOrder]
