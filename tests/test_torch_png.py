"""The port's PNG codec (``egonerf_torch/data/png.py``) against PIL, and its
image loading against the JAX package's ``_load_image``: pixels equal, bit
for bit (PNG is lossless; both divide the same uint8 values by 255 in
float32)."""
import io
import zlib

import numpy as np
import pytest
from PIL import Image

from egonerf_torch.data import png
from egonerf_torch.data.datasets import _load_image
from egonerf_tpu.data.datasets import _load_image as jax_load_image


def _pixels(shape, seed=0):
    rng = np.random.default_rng(seed)
    # smooth gradients plus noise: every filter type's predictor matters
    base = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 40
    return ((base + rng.integers(0, 25, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_writer_is_read_back_by_pil(filter_type, tmp_path):
    img = _pixels((23, 41, 3), seed=filter_type)
    path = tmp_path / "a.png"
    png.write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_image(path), img)


@pytest.mark.parametrize("mode,shape", [("L", (19, 33)), ("RGB", (19, 33, 3)),
                                        ("RGBA", (19, 33, 4))])
def test_pil_written_pngs_are_read(mode, shape, tmp_path):
    """PIL picks a filter a row (adaptive filtering), so these files mix all
    five filter types."""
    img = _pixels(shape, seed=len(shape))
    path = tmp_path / f"{mode}.png"
    Image.fromarray(img, mode).save(path)
    got = png.read_image(path)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode,shape", [("L", (12, 20)), ("RGB", (12, 20, 3)),
                                        ("RGBA", (12, 20, 4))])
def test_load_image_equals_jax(mode, shape, tmp_path):
    img = _pixels(shape, seed=7)
    path = tmp_path / "x.png"
    Image.fromarray(img, mode).save(path)
    for resize in (None, (20, 12), (10, 6)):
        got, want = _load_image(path, resize), jax_load_image(path, resize)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_jpeg_goes_through_pil_as_jax(tmp_path):
    path = tmp_path / "x.jpg"
    Image.fromarray(_pixels((16, 24, 3))).save(path)
    np.testing.assert_array_equal(_load_image(path), jax_load_image(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    import struct

    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _raw_png(w, h, depth, colour, interlace=0, data=b""):
    import struct

    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                                        interlace))
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


UNSUPPORTED = {
    "16-bit": (_raw_png(2, 2, 16, 2), "16-bit"),
    "palette": (_raw_png(2, 2, 8, 3), "palette"),
    "grey with alpha": (_raw_png(2, 2, 8, 4), "grey with alpha"),
    "Adam7": (_raw_png(2, 2, 8, 2, interlace=1), "Adam7"),
    "bad filter type": (_raw_png(1, 1, 8, 0, data=b"\x05\x00"), "filter type 5"),
    "short data": (_raw_png(2, 2, 8, 2, data=b"\x00" * 5), "needs"),
    "not a PNG": (b"GIF89a", "signature"),
}


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 17, 3), (17, 1, 3), (9, 31, 3),
                                   (31, 9, 3)])
def test_rows_of_mixed_filters_are_read(shape):
    """Every row under a filter of its own, all five mixed (the anti-diagonal
    reconstruction at each edge of the image): pixels equal, as PIL reads
    the same bytes."""
    h, w, _ = shape
    img = _pixels(shape, seed=h)
    kinds = np.random.default_rng(w).integers(0, 5, h).astype(np.uint8)
    kinds[0] = 4
    filtered = np.stack([png._filter(img.reshape(h, -1), k) for k in range(5)])
    raw = np.concatenate([kinds[:, None], filtered[kinds, np.arange(h)]], axis=1)
    data = _raw_png(w, h, 8, 2, data=raw.tobytes())
    np.testing.assert_array_equal(png.decode(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_kinds_raise(case):
    data, message = UNSUPPORTED[case]
    with pytest.raises(png.PNGError, match=message):
        png.decode(data)


def test_damaged_crc_raises():
    data = bytearray(png.encode(_pixels((4, 4, 3))))
    data[-20] ^= 1  # inside the IDAT chunk
    with pytest.raises(png.PNGError, match="CRC"):
        png.decode(bytes(data))


def test_pil_pngs_of_unsupported_kinds_raise(tmp_path):
    path = tmp_path / "p.png"
    Image.fromarray(_pixels((8, 8))).convert("P").save(path)
    with pytest.raises(png.PNGError, match="palette"):
        png.read_image(path)
    path16 = tmp_path / "i16.png"
    Image.fromarray(_pixels((8, 8)).astype(np.uint16) * 200).save(path16)
    with pytest.raises(png.PNGError, match="16-bit"):
        png.read_image(path16)


def test_without_pil_other_formats_name_their_format(tmp_path, monkeypatch):
    monkeypatch.setattr(png, "_pil", lambda: None)
    path = tmp_path / "x.jpg"
    Image.fromarray(_pixels((8, 8, 3))).save(path)
    with pytest.raises(RuntimeError, match="JPEG image needs PIL"):
        png.read_image(path)
    ok = tmp_path / "x.png"
    png.write_png(ok, _pixels((8, 8, 3)))
    assert png.read_image(ok).shape == (8, 8, 3)
    with pytest.raises(RuntimeError, match="resizing the PNG"):
        png.read_image(ok, (4, 4))


def test_writer_rejects_bad_input():
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 3), np.uint8), filter_type=5)
