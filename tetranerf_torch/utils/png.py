"""PNG codec on ``zlib`` and numpy, so that datasets load and write the same
way with and without Pillow.

- :func:`read_png`: 8-bit gray, gray+alpha, RGB and RGBA, non-interlaced,
  all five row filters. Other bit depths, interlaced files and palette
  images raise ``ValueError`` naming the file.
- :func:`encode_png`: 8-bit gray, gray+alpha, RGB or RGBA rows with
  filter 0 (none) or 1 (sub), as the bytes of a PNG file;
  :func:`write_png` writes them to a path.
- :func:`read_image`: PNG through :func:`read_png`, anything else (JPEG)
  through Pillow when it can be imported.
- :func:`image_size`: a PNG's or JPEG's width and height from its header
  (the preprocessing scripts' size read, without Pillow).

Unfiltering: the none, sub and up filters are whole-row numpy operations
(sub is a running sum modulo 256). Average and Paeth read the reconstructed
byte to the left, so a row holding them is sequential along x; the
decoder then runs a wavefront over the anti-diagonals ``x + y = t``, whose
pixels depend only on earlier diagonals: ``H + W - 1`` numpy steps, each
over a whole diagonal of every image decoded together (:func:`read_pngs`).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit samples); 3 (palette) is refused.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_BATCH = 16


def is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _SIGNATURE


def _parse(path):
    """``(height, width, channels, filter types u8[H], filtered bytes
    u8[H, W, C])`` of one PNG file."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color == 3:
        raise ValueError(f"{path}: palette PNGs are not supported")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported (8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * ch):
        raise ValueError(f"{path}: PNG data is {raw.size} bytes, expected "
                         f"{height * (1 + width * ch)}")
    raw = raw.reshape(height, 1 + width * ch)
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(types.max())}")
    return height, width, ch, types, raw[:, 1:].reshape(height, width, ch)


def _unfilter_rows(types: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Rows of filters 0-2 only. ``types [N, H]``, ``filt [N, H, W, C]``."""
    out = np.empty_like(filt)
    prior = np.zeros_like(filt[:, 0])
    for y in range(filt.shape[1]):
        cur = filt[:, y]
        row = cur.copy()
        t = types[:, y]
        sub = t == 1
        if sub.any():
            row[sub] = np.cumsum(cur[sub], axis=1, dtype=np.uint8)
        up = t == 2
        if up.any():
            row[up] = cur[up] + prior[up]
        out[:, y] = row
        prior = row
    return out


def _unfilter_wavefront(types: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Any filters: pixels on one anti-diagonal at a time. The images sit
    side by side on the last axis of a zero-bordered ``[H + 1, W + 1]``
    plane, so that the left, upper and upper-left neighbours of a pixel are
    fixed offsets in the flattened plane."""
    n, h, w, c = filt.shape
    stride = w + 1
    plane = np.zeros(((h + 1) * stride, n * c), np.int16)
    cur_all = np.moveaxis(filt, 0, 2).reshape(h, w, n * c).astype(np.int16)
    row_types = np.repeat(types.T, c, axis=1)  # [H, N * C]
    for t in range(h + w - 1):
        ys = np.arange(max(0, t - w + 1), min(h, t + 1))
        xs = t - ys
        idx = (ys + 1) * stride + xs + 1
        a = plane[idx - 1]
        b = plane[idx - stride]
        cc = plane[idx - stride - 1]
        pa = np.abs(b - cc)
        pb = np.abs(a - cc)
        pc = np.abs(a + b - 2 * cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        ft = row_types[ys]
        pred = np.where(ft == 1, a, 0)
        pred = np.where(ft == 2, b, pred)
        pred = np.where(ft == 3, (a + b) >> 1, pred)
        pred = np.where(ft == 4, paeth, pred)
        plane[idx] = (cur_all[ys, xs] + pred) & 255
    out = plane.reshape(h + 1, stride, n * c)[1:, 1:].astype(np.uint8)
    return np.moveaxis(out.reshape(h, w, n, c), 2, 0)


def _squeeze(img: np.ndarray) -> np.ndarray:
    return img[..., 0] if img.shape[-1] == 1 else img


def read_pngs(paths: Sequence) -> List[np.ndarray]:
    """Decode PNG files; files of one shape are unfiltered together.
    Returns ``uint8 [H, W]`` (gray) or ``[H, W, C]`` arrays."""
    parsed = [_parse(p) for p in paths]
    out: List = [None] * len(parsed)
    groups: dict = {}
    for i, (h, w, ch, _, _) in enumerate(parsed):
        groups.setdefault((h, w, ch), []).append(i)
    for same_shape in groups.values():
        # Batches of at most _BATCH images bound the int16 planes' memory.
        for b in range(0, len(same_shape), _BATCH):
            members = same_shape[b : b + _BATCH]
            types = np.stack([parsed[i][3] for i in members])
            filt = np.stack([parsed[i][4] for i in members])
            if types.max(initial=0) <= 2:
                imgs = _unfilter_rows(types, filt)
            else:
                imgs = _unfilter_wavefront(types, filt)
            for k, i in enumerate(members):
                out[i] = _squeeze(imgs[k])
    return out


def read_png(path) -> np.ndarray:
    """Decode one PNG file: ``uint8 [H, W]`` (gray) or ``[H, W, C]``."""
    return read_pngs([path])[0]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, filter_type: int = 1) -> bytes:
    """The bytes of an 8-bit PNG of ``uint8 [H, W]`` (gray) or ``[H, W, C]``
    with C = 1 (gray), 2 (gray+alpha), 3 (RGB) or 4 (RGBA), whose rows all
    use ``filter_type`` 0 (none) or 1 (sub)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}.get(img.shape[-1]) if img.ndim == 3 else None
    if color_type is None:
        raise ValueError(f"image of shape {image.shape} is not gray, gray+alpha, "
                         "RGB or RGBA")
    if filter_type not in (0, 1):
        raise ValueError(f"filter_type must be 0 or 1, got {filter_type}")
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch)
    if filter_type == 1:
        rows = rows.copy()
        rows[:, ch:] = img[:, 1:].reshape(h, -1) - img[:, :-1].reshape(h, -1)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return b"".join((_SIGNATURE, _chunk(b"IHDR", header),
                     _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
                     _chunk(b"IEND", b"")))


def write_png(path, image: np.ndarray, filter_type: int = 1) -> None:
    """Write :func:`encode_png` of ``image`` to ``path``."""
    try:
        data = encode_png(image, filter_type)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    with open(path, "wb") as f:
        f.write(data)


# JPEG start-of-frame markers (baseline, progressive, lossless, arithmetic):
# every 0xC0-0xCF but DHT (C4), JPG (C8) and DAC (CC).
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def image_size(path) -> tuple:
    """``(width, height)`` of a PNG (its IHDR chunk) or JPEG (its
    start-of-frame marker) file, read from the header alone."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == _SIGNATURE:
            if head[12:16] != b"IHDR":
                raise ValueError(f"{path}: PNG without an IHDR chunk first")
            return struct.unpack(">II", head[16:24])
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither a PNG nor a JPEG file")
        f.seek(2)
        while True:
            byte = f.read(1)
            if not byte:
                break
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":  # fill bytes
                marker = f.read(1)
            if not marker:
                break
            code = marker[0]
            if code in (0x01, 0xD8) or 0xD0 <= code <= 0xD7:  # no length field
                continue
            if code == 0xD9:  # end of image
                break
            length = struct.unpack(">H", f.read(2))[0]
            if code in _JPEG_SOF:
                height, width = struct.unpack(">xHH", f.read(5))
                return width, height
            f.seek(length - 2, 1)
    raise ValueError(f"{path}: JPEG without a start-of-frame marker")


def read_image(path) -> np.ndarray:
    """An 8-bit image file as ``uint8 [H, W]`` or ``[H, W, C]``: PNG by
    :func:`read_png`, other formats (JPEG) by Pillow."""
    if is_png(path):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: not a PNG file, and reading it needs Pillow, which is "
            "not installed"
        ) from None
    return np.asarray(Image.open(path))
