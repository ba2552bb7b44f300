"""Request images without Pillow: the port's PNG decoder and its pad and
bicubic resize (``ollama_operator_tpu_torch/server/images.py``), against
Pillow and the JAX package's ``models/vision.preprocess``.

- PNGs written here by a small encoder (every colour type, the bit depths
  the decoder takes, each of the five filters on its own and mixed, plain
  and Adam7, a palette with a tRNS chunk and one shorter than its indices)
  decode to Pillow's ``convert("RGB")`` pixels, uint8 for uint8; so do
  PNGs Pillow itself writes;
- the pad and resize give JAX ``preprocess``'s pixels uint8 for uint8 for
  square, wide, tall, upscaled and downscaled images (and the normalised
  floats equal), at the tiny tower's 16 and at CLIP's 336;
- a JPEG decodes through Pillow where Pillow imports, and without Pillow
  is refused with a 400 that names the format; a 16-bit PNG goes to
  Pillow too; a broken PNG is a 400.
"""

import base64
import io
import struct
import sys
import zlib
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from ollama_operator_tpu.models import vision as jvision
from ollama_operator_tpu_torch.runtime.errors import BadRequest
from ollama_operator_tpu_torch.server import images as I

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(rows, bpp, filters):
    """Raw scanlines → filtered bytes, row i under filters[i % len]."""
    out, prior = bytearray(), bytes(len(rows[0]))
    for i, row in enumerate(rows):
        ft = filters[i % len(filters)]
        line = bytearray([ft])
        for j, x in enumerate(row):
            a = row[j - bpp] if j >= bpp else 0
            b = prior[j]
            c = prior[j - bpp] if j >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            line.append((x - pred) & 255)
        out += line
        prior = row
    return bytes(out)


def _pack(samples, depth):
    """A row of samples [w * channels] → its bytes at ``depth`` bits."""
    if depth == 8:
        return bytes(samples.astype(np.uint8))
    per = 8 // depth
    pad = (-len(samples)) % per
    s = np.concatenate([samples, np.zeros(pad, samples.dtype)]).reshape(
        -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return bytes((s << shifts).sum(1).astype(np.uint8))


def encode_png(samples, color_type, depth=8, filters=(0,), interlace=0,
               palette=None, trns=None, idat_pieces=1):
    """uint8 samples [H, W, channels] → PNG bytes."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = [(0, 0, 1, 1)] if not interlace else ADAM7
    raw = b""
    for r0, c0, dr, dc in passes:
        sub = samples[r0::dr, c0::dc]
        if sub.size == 0:
            continue
        rows = [_pack(r.reshape(-1).astype(np.int64), depth) for r in sub]
        raw += _filter_rows(rows, bpp, filters)
    z = zlib.compress(raw)
    cut = [len(z) * i // idat_pieces for i in range(idat_pieces + 1)]
    out = I.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(palette, np.uint8)))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cut, cut[1:]):
        out += _chunk(b"IDAT", z[a:b])
    return out + _chunk(b"IEND", b"")


def pillow_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


CASES = [  # (colour type, bit depth, channels, sample range)
    (0, 8, 1, 256), (0, 4, 1, 16), (0, 2, 1, 4), (0, 1, 1, 2),
    (2, 8, 3, 256), (3, 8, 1, 200), (3, 4, 1, 16), (3, 2, 1, 4),
    (3, 1, 1, 2), (4, 8, 2, 256), (6, 8, 4, 256)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("ct,depth,ch,hi", CASES)
def test_png_decode_equals_pillow(ct, depth, ch, hi, filters, interlace):
    rng = np.random.default_rng(ct * 100 + depth * 10 + len(filters)
                                + 7 * filters[0] + interlace)
    h, w = (13, 11) if interlace else (7, 9)
    samples = rng.integers(0, hi, (h, w, ch)).astype(np.uint8)
    palette = (rng.integers(0, 256, (hi, 3)) if ct == 3 else None)
    data = encode_png(samples, ct, depth, filters, interlace, palette,
                      idat_pieces=2)
    got = I.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, pillow_rgb(data))


def test_png_palette_with_trns_and_short_palette_equal_pillow():
    rng = np.random.default_rng(3)
    samples = rng.integers(0, 6, (5, 8, 1)).astype(np.uint8)
    data = encode_png(samples, 3, 8, (4,), palette=rng.integers(
        0, 256, (6, 3)), trns=bytes([0, 128, 255]))
    np.testing.assert_array_equal(I.decode_png(data), pillow_rgb(data))
    # indices past a 4-entry palette
    data = encode_png(samples, 3, 8, (1,), palette=rng.integers(
        0, 256, (4, 3)))
    np.testing.assert_array_equal(I.decode_png(data), pillow_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_png_pillow_writes_decodes_equal(mode):
    rng = np.random.default_rng(11)
    im = Image.fromarray(rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
                         "RGB")
    if mode == "P":
        im = im.quantize(64)
    elif mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(I.decode_png(data), pillow_rgb(data))
    np.testing.assert_array_equal(
        I.decode_image(base64.b64encode(data).decode()), pillow_rgb(data))


@pytest.mark.parametrize("size", [16, 336])
@pytest.mark.parametrize("hw", [(16, 16), (336, 336), (20, 20), (480, 640),
                                (300, 200), (7, 5), (5, 23), (1024, 768),
                                (100, 101)])
def test_preprocess_equals_jax(hw, size):
    rng = np.random.default_rng(hw[0] * 7 + hw[1] + size)
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    cfg = jvision.VisionConfig(image_size=size, patch_size=8 if size == 16
                               else 14)
    want = jvision.preprocess(img, cfg)
    # the uint8 pixels behind both (normalisation is exact per value)
    pix = I.pixels(img, size)
    ref = np.round((want * jvision.CLIP_STD + jvision.CLIP_MEAN) * 255.0)
    np.testing.assert_array_equal(pix.astype(np.float64), ref)
    np.testing.assert_array_equal(I.preprocess(img, size), want)


def _jpeg():
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (24, 32, 3)).astype(np.uint8),
                    "RGB").save(buf, "JPEG")
    return buf.getvalue()


def test_jpeg_through_pillow_and_refused_without_it():
    data = _jpeg()
    b64 = base64.b64encode(data).decode()
    np.testing.assert_array_equal(I.decode_image(b64), pillow_rgb(data))
    with mock.patch.dict(sys.modules, {"PIL": None, "PIL.Image": None}):
        with pytest.raises(BadRequest) as e:
            I.decode_image(b64)
    assert str(e.value).startswith("invalid image: a JPEG image needs "
                                   "Pillow")


def test_sixteen_bit_png_goes_to_pillow():
    rng = np.random.default_rng(6)
    im = Image.fromarray(rng.integers(0, 65536, (9, 10)).astype(np.uint16))
    buf = io.BytesIO()
    im.save(buf, "PNG")
    data = buf.getvalue()
    assert data[24] == 16                     # the IHDR bit depth
    np.testing.assert_array_equal(I.decode_image(data), pillow_rgb(data))
    with mock.patch.dict(sys.modules, {"PIL": None, "PIL.Image": None}):
        with pytest.raises(BadRequest, match="16 bits"):
            I.decode_image(data)


def test_broken_images_are_400():
    data = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8), 2))
    data[40] ^= 0xFF                          # inside IDAT: a CRC error
    for bad in (bytes(data), b"hello", I.PNG_SIGNATURE + b"\0\0"):
        with pytest.raises(BadRequest, match="^invalid image: "):
            I.decode_image(bad)
    with pytest.raises(BadRequest, match="^invalid image: "):
        I.decode_image("not base64 at all!")


def _header(w, h, ct=2):
    return I.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ct, 0, 0, 0))


def test_pixel_bomb_header_is_400_as_pillow_refuses_it():
    """An IHDR past Pillow's limit (twice ``MAX_IMAGE_PIXELS``) is refused
    before anything is inflated or allocated, with Pillow's message."""
    limit = 2 * Image.MAX_IMAGE_PIXELS
    assert limit == 2 * I.MAX_IMAGE_PIXELS
    data = (_header(limit // 1000 + 1, 1000)
            + _chunk(b"IDAT", zlib.compress(b"\0" * 4096))
            + _chunk(b"IEND", b""))
    with pytest.raises(Image.DecompressionBombError):
        pillow_rgb(data)
    with pytest.raises(BadRequest, match="^invalid image: Image size "
                       r"\(\d+ pixels\) exceeds limit of 178956970 pixels"):
        I.decode_image(base64.b64encode(data).decode())


def test_idat_bomb_inflates_only_what_the_image_holds():
    """A 2×2 PNG whose image data inflates to 64 MiB past its 14 bytes
    decodes to Pillow's pixels (Pillow ignores the excess too) without
    expanding the excess; a large IHDR over too little data is a 400."""
    import tracemalloc
    rows = b"\0\x01\x02\x03\x04\x05\x06" + b"\0\x07\x08\x09\x0a\x0b\x0c"
    z = zlib.compress(rows + bytes(64 << 20), 9)
    assert len(z) < (1 << 20)
    data = _header(2, 2) + _chunk(b"IDAT", z) + _chunk(b"IEND", b"")
    tracemalloc.start()
    try:
        got = I.decode_png(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, pillow_rgb(data))
    assert peak < 4 * len(data) + (1 << 20), peak
    short = (_header(4000, 4000) + _chunk(b"IDAT", zlib.compress(rows))
             + _chunk(b"IEND", b""))
    with pytest.raises(OSError):
        pillow_rgb(short)
    with pytest.raises(BadRequest, match="^invalid image: truncated PNG"):
        I.decode_image(short)


@pytest.mark.parametrize("filters", [(3, 0, 4, 2, 2, 1, 4, 3), (2, 4, 2, 3),
                                     (4, 4, 1, 2, 3, 3)])
def test_png_mixed_filter_runs_equal_pillow(filters):
    """Rows reconstructed whole (None, Sub, Up below a known row) beside
    runs of Average and Paeth rows walked over anti-diagonals, and Up rows
    inside such runs."""
    rng = np.random.default_rng(len(filters) * 31 + filters[0])
    samples = rng.integers(0, 256, (len(filters) * 2 + 1, 19, 3)
                           ).astype(np.uint8)
    data = encode_png(samples, 2, 8, filters)
    np.testing.assert_array_equal(I.decode_png(data), pillow_rgb(data))
