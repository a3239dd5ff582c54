"""The port's EXR inspection and dataset tools against the JAX package's.

- `data/inspect.py`: `describe_exr` gives the JAX module's string for
  EXRs the port writes (ZIP and no compression, half and float, several
  channel groups); `process_channel_display` equals the JAX function for
  every channel class, a zero normal and an all-zero depth included; the
  PNG that `show_exr_channel` saves decodes to the quantized display
  array; the module never loads matplotlib.
- `tools/resize_exrs.py`: the same EXR tree through the JAX tool and the
  port tool gives byte-identical files and the same printed lines.
- `tools/make_synthetic_datasets.py`: with `generate_dataset` replaced in
  both tools, the two `main`s make equal calls (the generated bytes are
  held equal in tests/test_torch_port_host.py).
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from pixel_heal_thyself_tpu.data import inspect as jinspect
from pixel_heal_thyself_tpu_torch.data import inspect
from pixel_heal_thyself_tpu_torch.data.exr import write_exr
from pixel_heal_thyself_tpu_torch.tools import make_synthetic_datasets, resize_exrs

REPO = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    """A script of the repository's `tools/` (the JAX package's) as a module."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _channels(seed: int, h: int = 12, w: int = 20) -> dict[str, np.ndarray]:
    """Flat EXR channels of several groups: bare RGB (the default group),
    albedo, normal, depth, a two-channel group and a custom name."""
    rng = np.random.default_rng(seed)
    names = ["R", "G", "B", "albedo.R", "albedo.G", "albedo.B", "normal.X", "normal.Y",
             "normal.Z", "depth.Y", "motion.X", "motion.Y", "visibility.Y"]
    return {n: rng.uniform(-0.5, 3.0, (h, w)).astype(np.float32) for n in names}


def _decode_png(path: Path) -> np.ndarray:
    """An 8-bit RGB PNG with no row filters (`utils.images.write_png`)."""
    buf = path.read_bytes()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, shape = 8, b"", None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", data[:10])
            assert (depth, color) == (8, 2)
            shape = (h, w)
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], 1 + shape[1] * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(shape[0], shape[1], 3)


@pytest.mark.parametrize("compression,pixel_type", [("zip", "half"), ("none", "float"),
                                                    ("zips", "half")])
def test_describe_exr_matches_jax(tmp_path, compression, pixel_type):
    path = tmp_path / "frame.exr"
    write_exr(path, _channels(0), compression=compression, pixel_type=pixel_type)
    got = inspect.describe_exr(str(path))
    assert got == jinspect.describe_exr(str(path))
    assert f"Compression: {compression}" in got and "Default channels: 3" in got


@pytest.mark.parametrize("channel,kind", [
    ("default", "random"), ("albedo", "random"), ("specular", "random"),
    ("normal", "random"), ("normal", "zero_pixels"), ("normalA", "random"),
    ("depth", "random"), ("depth", "zero"), ("visibility", "one_channel"),
    ("normalVariance", "random"), ("motion", "random"),
])
def test_process_channel_display_matches_jax(channel, kind):
    rng = np.random.default_rng(1)
    data = rng.uniform(-2.0, 4.0, (9, 11, 3)).astype(np.float32)
    if kind == "zero_pixels":
        data[2:5, 3:7] = 0.0  # zero normals: no division by zero
    elif kind == "zero":
        data = np.zeros((9, 11, 1), np.float32)
    elif kind == "one_channel":
        data = data[..., :1]
    got = inspect.process_channel_display(data, channel)
    np.testing.assert_array_equal(got, jinspect.process_channel_display(data, channel))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("channel", ["default", "normal", "depth", "motion"])
def test_show_exr_channel_saves_the_quantized_display(tmp_path, channel, capfd):
    path = tmp_path / "frame.exr"
    write_exr(path, _channels(2), compression="zip", pixel_type="float")
    png = tmp_path / f"{channel}.png"
    disp = inspect.show_exr_channel(str(path), channel, save_path=str(png))
    np.testing.assert_array_equal(
        disp, jinspect.process_channel_display(jinspect.read_exr(str(path))[channel], channel))
    img = _decode_png(png)
    want = disp[..., None] if disp.ndim == 2 else disp
    want = np.repeat(want, 3, -1) if want.shape[-1] == 1 else want
    if want.shape[-1] == 2:
        want = np.concatenate([want, np.zeros_like(want[..., :1])], -1)
    np.testing.assert_array_equal(img, np.clip(want * 255.0, 0, 255).astype(np.uint8))
    assert f"Channel: {channel}" in capfd.readouterr().out  # the project logger's stream


def test_show_exr_channel_without_a_path_returns_the_array(tmp_path):
    path = tmp_path / "frame.exr"
    write_exr(path, _channels(3), compression="zip", pixel_type="half")
    disp = inspect.show_exr_channel(str(path), "albedo")
    assert disp.shape == (12, 20, 3) and list(tmp_path.iterdir()) == [path]
    with pytest.raises(KeyError, match="not in"):
        inspect.show_exr_channel(str(path), "specular")
    with pytest.raises(ValueError, match="exr"):
        inspect.show_exr_info(str(tmp_path / "frame.png"))


def test_inspect_cli_never_loads_matplotlib(tmp_path):
    path = tmp_path / "frame.exr"
    write_exr(path, _channels(4), compression="zip", pixel_type="half")
    code = (
        "import json, sys\n"
        "from pixel_heal_thyself_tpu_torch.data import inspect\n"
        f"inspect.main([{str(path)!r}, 'normal', '--save', {str(tmp_path / 'n.png')!r}])\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, check=True)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert proc.stdout.startswith(jinspect.describe_exr(str(path)) + "\n")
    assert _decode_png(tmp_path / "n.png").shape == (12, 20, 3)


def _exr_tree(root: Path) -> None:
    (root / "sub").mkdir(parents=True)
    write_exr(root / "a_32.exr", _channels(5, 16, 24), compression="zip", pixel_type="float")
    write_exr(root / "sub" / "b_1024.exr", _channels(6, 10, 14), compression="none",
              pixel_type="half")
    (root / "sub" / "broken.exr").write_bytes(b"not an exr at all")


@pytest.mark.parametrize("scale", [0.5, 0.25])
def test_resize_exrs_matches_jax_tool(tmp_path, capsys, monkeypatch, scale):
    _exr_tree(tmp_path / "src")
    shutil.copytree(tmp_path / "src", tmp_path / "jax")
    shutil.copytree(tmp_path / "src", tmp_path / "port")
    jtool = _jax_tool("resize_exrs")
    monkeypatch.setattr(sys, "argv", ["resize_exrs.py", str(tmp_path / "jax"), "--scale",
                                      str(scale)])
    jtool.main()
    want = capsys.readouterr().out.replace(str(tmp_path / "jax"), "ROOT")
    resize_exrs.main([str(tmp_path / "port"), "--scale", str(scale)])
    got = capsys.readouterr().out.replace(str(tmp_path / "port"), "ROOT")
    assert got == want and "Failed to resize ROOT/sub/broken.exr" in got
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.exr"))
    assert len(files) == 3
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert (tmp_path / "port" / "a_32.exr").read_bytes() != (tmp_path / "src" / "a_32.exr").read_bytes()


def test_make_synthetic_datasets_makes_the_jax_tools_calls(monkeypatch, tmp_path):
    jtool = _jax_tool("make_synthetic_datasets")
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jtool, "generate_dataset",
                        lambda *a, **k: calls["jax"].append((a, k)))
    monkeypatch.setattr(make_synthetic_datasets, "generate_dataset",
                        lambda *a, **k: calls["port"].append((a, k)))
    monkeypatch.setattr(sys, "argv", ["make_synthetic_datasets.py", "--root", str(tmp_path)])
    jtool.main()
    make_synthetic_datasets.main(["--root", str(tmp_path)])
    assert len(calls["jax"]) == 4 and calls["port"] == calls["jax"]
    assert {k["seed"] for _, k in calls["port"]} == {990819, 77}
