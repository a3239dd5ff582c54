"""Self-contained OpenEXR scanline codec (numpy, no external EXR deps).

The reference reads EXRs through `pyexr` (`pht/models/afgsa/
preprocessing.py:81-93`, `util.py:17-68`), which this image does not ship.
This module implements the subset of OpenEXR 2.0 the pipeline needs:

- single-part scanline images, increasing line order
- HALF and FLOAT channels
- NONE, ZIPS (1 line/chunk) and ZIP (16 lines/chunk) compression
- pyexr-style channel grouping: `read_exr(path)` returns
  {group: HxWxC float32}, where a channel named "normal.R" lands in group
  "normal" and bare "R"/"G"/"B" land in "default", ordered R,G,B,A
  (X,Y,Z for vector groups) like pyexr's channel maps.

The ZIP predictor/interleave matches OpenEXR's ImfZip (delta-encode bytes
then split even/odd halves), vectorized with numpy.

Copy of the JAX package's `pixel_heal_thyself_tpu/data/exr.py`, so that the
port imports nothing of that package; tests/test_torch_port_host.py
holds the two equal.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIXEL_TYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_TYPE_IDS = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
_COMPRESSION_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP
_SUFFIX_ORDER = {"R": 0, "G": 1, "B": 2, "A": 3, "X": 0, "Y": 1, "Z": 2}


# ---------------------------------------------------------------------------
# ZIP pre/post processing (OpenEXR ImfZip reorder + delta predictor)


def _zip_compress(raw: bytes) -> bytes:
    arr = np.frombuffer(raw, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = arr[0::2]
    t[half:] = arr[1::2]
    d = t.astype(np.int16)
    d[1:] = d[1:] - t[:-1].astype(np.int16) + (128 + 256)
    return zlib.compress(d.astype(np.uint8).tobytes())


def _zip_decompress(data: bytes, out_size: int) -> bytes:
    t = np.frombuffer(zlib.decompress(data), np.uint8).copy()
    if len(t) != out_size:
        raise ValueError("corrupt EXR zip chunk")
    # undo delta: t[i] = t[i-1] + t[i] - 128 (mod 256) — a cumulative sum
    d = t.astype(np.int64)
    d[1:] -= 128
    t = np.cumsum(d, dtype=np.int64).astype(np.uint8)
    # undo interleave
    half = (out_size + 1) // 2
    out = np.empty(out_size, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


# ---------------------------------------------------------------------------
# attribute encoding


def _write_attr(f, name: str, type_name: str, value: bytes) -> None:
    f.write(name.encode() + b"\0" + type_name.encode() + b"\0")
    f.write(struct.pack("<i", len(value)))
    f.write(value)


def _read_null_str(buf: memoryview, pos: int) -> tuple[str, int]:
    end = pos
    while buf[end] != 0:
        end += 1
    return bytes(buf[pos:end]).decode(), end + 1


def write_exr(
    path: str | Path,
    channels: dict[str, np.ndarray],
    compression: str = "zip",
    pixel_type: str = "half",
) -> None:
    """Write a scanline EXR. `channels` maps channel name → HxW array."""
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    dtype = {"half": np.float16, "float": np.float32}[pixel_type]
    names = sorted(channels)  # EXR chlist must be alphabetical
    first = channels[names[0]]
    height, width = first.shape
    for n in names:
        if channels[n].shape != (height, width):
            raise ValueError("all channels must share the same shape")

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))

        chlist = b""
        for n in names:
            chlist += (
                n.encode()
                + b"\0"
                + struct.pack("<i", _PIXEL_TYPE_IDS[np.dtype(dtype)])
                + struct.pack("<BBBB", 0, 0, 0, 0)
                + struct.pack("<ii", 1, 1)
            )
        chlist += b"\0"
        _write_attr(f, "channels", "chlist", chlist)
        _write_attr(f, "compression", "compression", struct.pack("<B", comp_id))
        box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", struct.pack("<B", 0))
        _write_attr(f, "pixelAspectRatio", "float", struct.pack("<f", 1.0))
        _write_attr(f, "screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\0")  # end of header

        lines_per_chunk = _COMPRESSION_LINES[comp_id]
        num_chunks = -(-height // lines_per_chunk)
        offset_table_pos = f.tell()
        f.write(b"\0" * (8 * num_chunks))

        data = {n: np.ascontiguousarray(channels[n], dtype=dtype) for n in names}
        offsets = []
        for ci in range(num_chunks):
            y0 = ci * lines_per_chunk
            y1 = min(y0 + lines_per_chunk, height)
            raw = b"".join(
                data[n][y].tobytes() for y in range(y0, y1) for n in names
            )
            if comp_id == 0:
                payload = raw
            else:
                payload = _zip_compress(raw)
                if len(payload) >= len(raw):
                    payload = raw
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(payload)))
            f.write(payload)

        f.seek(offset_table_pos)
        f.write(struct.pack(f"<{num_chunks}Q", *offsets))


def _parse_header(buf: memoryview) -> dict:
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file (bad magic 0x{magic & 0xFFFFFFFF:08x})")
    if version & 0x200:
        raise NotImplementedError("tiled EXRs are not supported")
    if version & 0x800:
        raise NotImplementedError("deep-data EXRs are not supported")
    if version & 0x1000:
        raise NotImplementedError("multi-part EXRs are not supported")
    pos = 8

    channels: list[tuple[str, int]] = []
    comp_id = 0
    data_window = (0, 0, 0, 0)
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_null_str(buf, pos)
        _type, pos = _read_null_str(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        value = bytes(buf[pos : pos + size])
        pos += size
        if name == "channels":
            cpos = 0
            vm = memoryview(value)
            while vm[cpos] != 0:
                cname, cpos = _read_null_str(vm, cpos)
                (ptype,) = struct.unpack_from("<i", vm, cpos)
                cpos += 4 + 4 + 8  # pixel type + pLinear/reserved + samplings
                channels.append((cname, ptype))
        elif name == "compression":
            comp_id = value[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", value)

    x0, y0, x1, y1 = data_window
    return {
        "channels": channels,
        "data_window": data_window,
        "width": x1 - x0 + 1,
        "height": y1 - y0 + 1,
        "compression": comp_id,
        "header_end": pos,
    }


def read_exr_header(path: str | Path) -> dict:
    """Parse just the EXR header: channels, geometry, compression.

    Returns {"channels": [(name, pixel_type_id)], "data_window": (x0,y0,x1,y1),
    "width", "height", "compression", "header_end" (byte offset past the
    header terminator)}. Backs the inspection helpers (`data/inspect.py`).

    Reads a bounded, doubling prefix of the file rather than the whole
    payload — describing a multi-hundred-MB frame should not pay its full
    I/O cost (headers are a few KB).
    """
    size = 1 << 16
    with open(path, "rb") as f:
        buf = f.read(size)
        while True:
            try:
                return _parse_header(memoryview(buf))
            except (struct.error, IndexError, ValueError):
                more = f.read(size)
                if not more:  # truly truncated/corrupt: surface the error
                    return _parse_header(memoryview(buf))
                buf += more
                size *= 2


def read_exr_channels(path: str | Path) -> dict[str, np.ndarray]:
    """Read a scanline EXR into {channel name: HxW float32}."""
    buf = memoryview(Path(path).read_bytes())
    hdr = _parse_header(buf)
    channels = hdr["channels"]
    comp_id = hdr["compression"]
    pos = hdr["header_end"]

    if comp_id not in _COMPRESSION_LINES:
        raise NotImplementedError(f"unsupported EXR compression id {comp_id}")

    x0, y0, x1, y1 = hdr["data_window"]
    width, height = x1 - x0 + 1, y1 - y0 + 1
    lines_per_chunk = _COMPRESSION_LINES[comp_id]
    num_chunks = -(-height // lines_per_chunk)
    offsets = struct.unpack_from(f"<{num_chunks}Q", buf, pos)

    names = [c[0] for c in channels]  # already alphabetical in the file
    dtypes = {c[0]: _PIXEL_TYPES[c[1]] for c in channels}
    line_bytes = {n: width * np.dtype(dtypes[n]).itemsize for n in names}
    bytes_per_line = sum(line_bytes.values())
    out = {n: np.empty((height, width), np.float32) for n in names}

    for off in offsets:
        # place each chunk by its own y coordinate (not the offset-table
        # index) so DECREASING_Y line order decodes correctly too
        y_file, size = struct.unpack_from("<ii", buf, off)
        cy0 = y_file - y0
        cy1 = min(cy0 + lines_per_chunk, height)
        payload = bytes(buf[off + 8 : off + 8 + size])
        raw_size = (cy1 - cy0) * bytes_per_line
        raw = payload if size == raw_size else _zip_decompress(payload, raw_size)
        p = 0
        for y in range(cy0, cy1):
            for n in names:
                nb = line_bytes[n]
                out[n][y] = np.frombuffer(raw[p : p + nb], dtypes[n]).astype(
                    np.float32,
                )
                p += nb
    return out


def _group_key(name: str) -> tuple[str, str]:
    if "." in name:
        g, _, suffix = name.rpartition(".")
        return g, suffix
    return "default", name


def read_exr(path: str | Path) -> dict[str, np.ndarray]:
    """pyexr-style read: groups of channels stacked to HxWxC float32."""
    flat = read_exr_channels(path)
    groups: dict[str, list[tuple[str, np.ndarray]]] = {}
    for name, arr in flat.items():
        g, suffix = _group_key(name)
        groups.setdefault(g, []).append((suffix, arr))
    out = {}
    for g, items in groups.items():
        items.sort(key=lambda it: (_SUFFIX_ORDER.get(it[0], 99), it[0]))
        out[g] = np.stack([a for _, a in items], axis=-1)
    return out


def write_exr_groups(
    path: str | Path,
    groups: dict[str, np.ndarray],
    compression: str = "zip",
    pixel_type: str = "half",
) -> None:
    """Inverse of `read_exr`: {group: HxWxC} → named channels on disk.

    'default' groups get bare R/G/B/A names (Y for 1-channel); others get
    '<group>.<suffix>' with R/G/B/A suffixes (Z for 1-channel depth-like).
    """
    channels: dict[str, np.ndarray] = {}
    for g, arr in groups.items():
        if arr.ndim == 2:
            arr = arr[..., None]
        c = arr.shape[-1]
        if c == 1:
            suffixes = ["Y"] if g == "default" else ["Z"]
        elif c <= 4:
            suffixes = ["R", "G", "B", "A"][:c]
        else:
            raise ValueError(
                f"group {g!r} has {c} channels; EXR groups carry at most "
                "4 (R/G/B/A) — split wider arrays into named groups",
            )
        for i, s in enumerate(suffixes):
            name = s if g == "default" else f"{g}.{s}"
            channels[name] = arr[..., i]
    write_exr(path, channels, compression=compression, pixel_type=pixel_type)
