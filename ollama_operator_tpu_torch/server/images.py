"""Request images → CLIP-normalised pixels, without Pillow where possible.

The JAX package decodes ``images`` with Pillow (``Image.open(...)
.convert("RGB")``) and preprocesses them with Pillow (pad to a square of
the CLIP mean colour, bicubic resize, normalise). The port carries its
own code for both, so that a host without Pillow serves them the same:

- :func:`decode_png`: a PNG decoder on ``zlib`` (8-bit gray, RGB, gray +
  alpha and RGBA; gray and palette at 1, 2, 4 and 8 bits; filters 0–4;
  non-interlaced and Adam7; every chunk's CRC checked; Pillow's limit
  on pixels checked before anything is inflated, and no more inflated
  than the image holds) converting to RGB
  as Pillow's ``convert("RGB")`` does: alpha dropped, gray replicated
  (low bit depths scaled to 0..255), palette looked up;
- :func:`resize_bicubic`: Pillow's separable bicubic resample (a = -0.5,
  the support widened by the reduction factor, 22-bit fixed-point
  coefficients, the horizontal pass then the vertical one, each rounded
  and clipped to uint8), so the pixels equal Pillow's uint8 for uint8;
- :func:`preprocess`: pad, resize and normalise as the JAX package's
  ``models/vision.preprocess``.

:func:`decode_image` takes any request image: a PNG the decoder covers
goes through it; anything else (JPEG, a 16-bit PNG, GIF, ...) goes to
Pillow when Pillow imports, and is refused otherwise with a
:class:`~..runtime.errors.BadRequest` that names its format.
"""

from __future__ import annotations

import base64
import io
import math
import struct
import zlib
import numpy as np

from ..models.vision import CLIP_MEAN, CLIP_STD
from ..runtime.errors import BadRequest

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each PNG colour type and the bit depths this decoder takes
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
# Adam7: (row start, column start, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
_PRECISION_BITS = 22   # Pillow's 8-bit resample: 32 - 8 - 2
# Pillow's Image.MAX_IMAGE_PIXELS: it refuses an image of more than twice
# as many pixels before decoding it (DecompressionBombError)
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


class UnsupportedPNG(ValueError):
    """A well-formed PNG outside what :func:`decode_png` covers."""


def image_format(data: bytes) -> str:
    """The container format of ``data`` by its magic bytes."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data.startswith(b"BM"):
        return "BMP"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return "unknown"


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file (bad CRC in {kind!r})")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND)")


def _unfilter(raw: np.ndarray, h: int, rowbytes: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters of ``h`` rows of ``rowbytes`` bytes (each
    row led by its filter byte) → [h, rowbytes] uint8.

    A filter unit is ``bpp`` bytes, the distance the filters look left.
    Rows under None and Sub depend on no other row, and an Up row on the
    row above alone: going down the image, each such row whose row above
    is already known is reconstructed whole (a copy, a cumulative sum mod
    256 along the row, one add). The rest — Average and Paeth rows, and
    any row below one of them until the next None or Sub row — are walked
    together over anti-diagonals of (row, unit): a row starts one step
    after the row above it starts (at step 0 below a known row), so each
    step is vectorised and every neighbour it reads (left, up, up-left)
    was reconstructed by an earlier step."""
    rows = raw.reshape(h, rowbytes + 1)
    ft = rows[:, 0]
    if ft.size and int(ft.max()) > 4:
        raise ValueError(f"bad PNG filter type {int(ft.max())}")
    U = rowbytes // bpp
    filt = rows[:, 1:].reshape(h, U, bpp)
    rec = np.zeros((h + 1, U + 1, bpp), np.uint8)   # a zero row and column
    walk, start = [], []
    known = True                    # the zero row above the first row
    for r, t in enumerate(ft.tolist()):
        if t == 0:
            rec[r + 1, 1:] = filt[r]
        elif t == 1:
            rec[r + 1, 1:] = np.cumsum(filt[r], axis=0, dtype=np.uint8)
        elif t == 2 and known:
            rec[r + 1, 1:] = filt[r] + rec[r, 1:]          # wraps mod 256
        else:
            start.append(start[-1] + 1 if not known else 0)
            walk.append(r)
            known = False
            continue
        known = True
    if not walk:
        return rec[1:, 1:].reshape(h, rowbytes)
    start = np.asarray(start)
    order = np.argsort(start, kind="stable")
    s_sorted, w_rows = start[order], np.asarray(walk)[order]
    w_ft = ft[w_rows].astype(np.int16)[:, None]
    for d in range(int(s_sorted[-1]) + U):
        lo = np.searchsorted(s_sorted, d - U + 1, "left")
        hi = np.searchsorted(s_sorted, d, "right")
        rs, us = w_rows[lo:hi], d - s_sorted[lo:hi]
        a = rec[rs + 1, us].astype(np.int16)           # left
        b = rec[rs, us + 1].astype(np.int16)           # up
        c = rec[rs, us].astype(np.int16)               # up-left
        t = w_ft[lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, b, c))      # Paeth
        pred = np.where(t == 3, (a + b) >> 1, pred)
        pred = np.where(t == 2, b, pred)
        rec[rs + 1, us + 1] = (filt[rs, us] + pred).astype(np.uint8)
    return rec[1:, 1:].reshape(h, rowbytes)


def _samples(rows: np.ndarray, w: int, depth: int, channels: int
             ) -> np.ndarray:
    """Reconstructed rows [h, rowbytes] → samples [h, w, channels]."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    # 1, 2 and 4 bits: one channel, the first sample in the high bits
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def decode_png(data: bytes) -> np.ndarray:
    """A PNG → uint8 [H, W, 3], converted as Pillow's ``convert("RGB")``.
    Raises :class:`UnsupportedPNG` for a well-formed PNG outside the
    decoder's set (16-bit samples, another compression or filter method)
    and ValueError for a broken one."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    hdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad IHDR chunk")
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError("bad PLTE chunk")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ct, comp, fmethod, interlace = hdr
    if ct not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"bad PNG colour type {ct} / bit depth {depth}")
    if depth not in _DEPTHS[ct] or comp or fmethod or interlace > 1:
        raise UnsupportedPNG(f"PNG colour type {ct} at {depth} bits, "
                             f"interlace {interlace}")
    if not (w and h):
        raise ValueError("PNG of zero size")
    if ct == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"Image size ({w * h} pixels) exceeds limit of "
                         f"{2 * MAX_IMAGE_PIXELS} pixels, could be "
                         f"decompression bomb DOS attack.")
    ch = _CHANNELS[ct]
    bpp = max(1, ch * depth // 8)
    passes = []          # (r0, c0, dr, dc, rows, columns, row bytes)
    for r0, c0, dr, dc in ([(0, 0, 1, 1)] if interlace == 0 else _ADAM7):
        ph, pw = -(-(h - r0) // dr), -(-(w - c0) // dc)
        if ph > 0 and pw > 0:
            passes.append((r0, c0, dr, dc, ph, pw,
                           -(-(pw * ch * depth) // 8)))
    expected = sum(ph * (rb + 1) for *_, ph, _, rb in passes)
    # inflate no more than the image holds: data past it is ignored, as
    # Pillow ignores it, and never expanded
    try:
        raw = np.frombuffer(zlib.decompressobj().decompress(
            b"".join(idat), expected), np.uint8)
    except zlib.error as e:
        raise ValueError(f"bad PNG image data: {e}") from None
    if raw.size < expected:
        raise ValueError("truncated PNG image data")
    out = np.zeros((h, w, ch), np.uint8)
    pos = 0
    for r0, c0, dr, dc, ph, pw, rowbytes in passes:
        n = ph * (rowbytes + 1)
        rows = _unfilter(raw[pos:pos + n], ph, rowbytes, bpp)
        pos += n
        out[r0::dr, c0::dc] = _samples(rows, pw, depth, ch)
    if ct == 3:
        if int(out.max()) >= len(palette):
            # Pillow reads such an index as black (a zero-filled palette)
            palette = np.concatenate(
                [palette, np.zeros((256 - len(palette), 3), np.uint8)])
        return palette[out[..., 0]]
    if ct in (0, 4):
        g = out[..., 0]
        if depth < 8:
            g = (g.astype(np.int32) * 255 // ((1 << depth) - 1)
                 ).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=-1)
    return np.ascontiguousarray(out[..., :3])


def _pillow_rgb(data: bytes, what: str) -> np.ndarray:
    """Pillow's decode of an image the port's decoder does not cover;
    ``what`` names it in the refusal when Pillow does not import."""
    try:
        from PIL import Image
    except ImportError:
        raise BadRequest(f"invalid image: {what} needs Pillow, which this "
                         f"server does not have; send an 8-bit PNG"
                         ) from None
    try:
        im = Image.open(io.BytesIO(data)).convert("RGB")
    except Exception as e:  # noqa: BLE001 — any decoder failure is a 400
        raise BadRequest(f"invalid image: {e}") from e
    return np.asarray(im, np.uint8)


def decode_image(b64) -> np.ndarray:
    """One request image (base64 text, or raw bytes) → uint8 [H, W, 3].
    Refused with a 400 ("invalid image: ...") when it cannot be
    decoded."""
    try:
        data = (base64.b64decode(b64) if isinstance(b64, str)
                else bytes(b64))
    except Exception as e:  # noqa: BLE001 — bad base64 is the client's
        raise BadRequest(f"invalid image: {e}") from e
    fmt = image_format(data)
    if fmt == "PNG":
        try:
            return decode_png(data)
        except UnsupportedPNG as e:
            return _pillow_rgb(data, f"a {e} image")
        except ValueError as e:
            raise BadRequest(f"invalid image: {e}") from e
    return _pillow_rgb(data, f"a {fmt} image" if fmt != "unknown"
                       else "an image of an unrecognised format")


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bicubic filter over a whole axis: (first input index [out], integer
    coefficients [out, ksize], 0 past each output's window)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in ws:
            ww += v
        for x, v in enumerate(ws):
            if ww != 0.0:
                v /= ww
            kk[xx, x] = (int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << _PRECISION_BITS)))
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` of uint8 [H, W, C]:
    a fixed-point sum from a half-unit start, shifted and clipped."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)      # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for x in range(kk.shape[1]):
        idx = np.minimum(xmins + x, in_size - 1)
        acc += src[idx] * kk[:, x][:, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] → [size, size, 3] as Pillow's ``Image.resize((size,
    size), Image.BICUBIC)`` gives it: the horizontal pass, then the
    vertical one, each only where that axis changes."""
    if img.shape[:2] == (size, size):
        return img.copy()
    if img.shape[1] != size:
        img = _resample_axis(img, size, 1)
    if img.shape[0] != size:
        img = _resample_axis(img, size, 0)
    return img


def pad_square(img: np.ndarray) -> np.ndarray:
    """A non-square uint8 image centred on a square canvas of the CLIP
    mean colour, at ((side - w) // 2, (side - h) // 2)."""
    h, w = img.shape[:2]
    if h == w:
        return img
    side = max(h, w)
    mean_rgb = [int(round(c * 255)) for c in CLIP_MEAN]
    canvas = np.empty((side, side, 3), np.uint8)
    canvas[:] = mean_rgb
    y0, x0 = (side - h) // 2, (side - w) // 2
    canvas[y0:y0 + h, x0:x0 + w] = img
    return canvas


def pixels(img_hwc_u8: np.ndarray, image_size: int) -> np.ndarray:
    """The uint8 pixels the tower sees: padded to a square, resized."""
    return resize_bicubic(pad_square(np.asarray(img_hwc_u8, np.uint8)),
                          image_size)


def preprocess(img_hwc_u8: np.ndarray, image_size: int) -> np.ndarray:
    """uint8 [H, W, 3] → CLIP-normalised float32 [size, size, 3], as the
    JAX package's ``models/vision.preprocess`` (llava-1.5: pad to a square
    with the CLIP mean colour, bicubic resize, normalise)."""
    x = np.asarray(pixels(img_hwc_u8, image_size), np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD
