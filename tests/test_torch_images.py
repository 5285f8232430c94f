"""The port's image IO (data/png.py with csrc/pngfilter.cpp, and
data/images.py with its png and jpeg backends) against PIL and the JAX
package's data/images.py, on files made from a seed (the JPEG decoder,
csrc/jpeg.cpp, is held on committed files in test_torch_jpeg.py).
Tolerances: pixels and sizes exact; load_gray atol 1e-6 against the JAX
native loader (both resize in double precision and round once to
float32), exact for JPEG."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from detectorfreesfm_tpu.data import images as JI
from detectorfreesfm_tpu_torch.data import images as TI
from detectorfreesfm_tpu_torch.data import png

RNG_SEED = 7


def _photo(h, w, seed, channels=0):
    """A smooth image with noise: every PIL filter type shows up on it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 90 * np.sin(xx / 9.0 + seed) * np.cos(yy / 13.0)
    noise = rng.integers(-40, 40, (h, w))
    a = np.where(rng.random((h, w)) < 0.3, base + noise, base)
    if channels:
        a = np.stack([np.roll(a, 5 * c, axis=1) + 20 * c
                      for c in range(channels)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def _filter_types(data):
    """Row filter types used in a PNG file (8-bit, non-interlaced)."""
    chunks = dict()
    idat = b""
    for kind, body in png._chunks(data, "x"):
        if kind == b"IDAT":
            idat += body
        chunks[kind] = body
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    stride = (w * spp * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


def _pil_png(arr, mode, palette=None):
    im = Image.fromarray(arr, mode)
    if palette is not None:
        im.putpalette(palette.reshape(-1).tolist())
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


# --- data/png.py against PIL, both ways -------------------------------------


@pytest.mark.parametrize("mode,shape", [
    ("L", (37, 53)), ("L", (1, 1)), ("RGB", (41, 29, 3)),
    ("RGBA", (33, 47, 4)), ("LA", (21, 19, 2)), ("RGB", (64, 63, 3))])
def test_png_reader_equals_pil(mode, shape):
    """PIL writes (adaptive filters), the port reads: the same pixels, and
    convert("L") / convert("RGB") bit for bit."""
    arr = _photo(shape[0], shape[1], sum(shape),
                 shape[2] if len(shape) == 3 else 0)
    data = _pil_png(arr, mode)
    got = png.decode_png(data)
    pil = Image.open(io.BytesIO(data))
    assert got.mode == mode and got.size == pil.size
    np.testing.assert_array_equal(got.pixels, np.asarray(pil))
    np.testing.assert_array_equal(png.to_gray(got),
                                  np.asarray(pil.convert("L")))
    np.testing.assert_array_equal(png.to_rgb(got),
                                  np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("n_colors", [2, 4, 16, 200])
def test_png_palette_equals_pil(n_colors):
    """Palette images at the bit depths PIL picks for the palette size
    (1, 2, 4 and 8 bits)."""
    rng = np.random.default_rng(n_colors)
    idx = rng.integers(0, n_colors, (23, 31)).astype(np.uint8)
    data = _pil_png(idx, "P", rng.integers(0, 256, (n_colors, 3)))
    bits = {2: 1, 4: 2, 16: 4, 200: 8}[n_colors]
    assert data[24] == bits  # IHDR bit depth
    got = png.decode_png(data)
    pil = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(got.pixels, np.asarray(pil))
    np.testing.assert_array_equal(png.to_gray(got),
                                  np.asarray(pil.convert("L")))
    np.testing.assert_array_equal(png.to_rgb(got),
                                  np.asarray(pil.convert("RGB")))


def test_png_reader_takes_every_filter_pil_writes():
    """The filter types PIL's adaptive choice writes all occur in the files
    of the reader tests above."""
    seen = set()
    for mode, shape in (("L", (37, 53)), ("RGB", (41, 29, 3)),
                        ("RGBA", (33, 47, 4))):
        arr = _photo(shape[0], shape[1], sum(shape),
                     shape[2] if len(shape) == 3 else 0)
        seen |= _filter_types(_pil_png(arr, mode))
    noise = np.random.default_rng(RNG_SEED).integers(0, 256, (30, 40),
                                                     dtype=np.uint8)
    data = _pil_png(noise, "L")
    seen |= _filter_types(data)
    np.testing.assert_array_equal(png.decode_png(data).pixels, noise)
    assert seen >= {0, 1, 2, 4}, seen


@pytest.mark.parametrize("unfilter", ["native", "python"])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [0, 3, 4])
def test_png_reader_undoes_each_filter(kind, channels, unfilter):
    """Every row filter, also Average (3), which PIL does not pick: rows
    filtered here by the PNG rules, then read back to the same pixels by
    the C++ unfilter and by its Python fallback."""
    arr = _photo(17, 23, kind + channels, channels)
    h = arr.shape[0]
    bpp = max(channels, 1)
    rows = arr.reshape(h, -1).astype(np.int32)
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(np.concatenate([[kind], (cur - pred) & 0xFF]))
        prev = cur
    ctype = {0: 0, 3: 2, 4: 6}[channels]
    ihdr = struct.pack(">IIBBBBB", arr.shape[1], h, 8, ctype, 0, 0, 0)

    def chunk(k, b):
        return (struct.pack(">I", len(b)) + k + b
                + struct.pack(">I", zlib.crc32(k + b)))

    data = (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(
                np.concatenate(out).astype(np.uint8).tobytes()))
            + chunk(b"IEND", b""))
    np.testing.assert_array_equal(
        png.decode_png(data, unfilter=unfilter).pixels, arr)
    assert png.last_unfilter == unfilter
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))), arr)


@pytest.mark.parametrize("content", ["noise", "smooth"])
@pytest.mark.parametrize("shape", [(37, 53), (1, 7), (41, 29, 3)])
def test_png_writer_read_by_pil(shape, content, tmp_path):
    """The port writes (adaptive filters), PIL reads the same pixels."""
    if content == "noise":
        arr = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                         dtype=np.uint8)
    else:
        arr = _photo(shape[0], shape[1], 5, shape[2] if len(shape) == 3
                     else 0)
    path = str(tmp_path / "w.png")
    png.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(png.read_png(path).pixels, arr)


@pytest.mark.parametrize("channels", [0, 3])
def test_png_adaptive_writer_picks_the_least_signed_sum(channels):
    """Each row's filter is the one whose bytes, taken as signed, sum to
    the least magnitude (ties to the lower type); on a smooth image with
    noise every type but 0 wins some rows, and PIL and both unfilters
    read the file back to the same pixels."""
    arr = _photo(60, 70, 11, channels)
    arr[:10] = 200  # flat rows: Sub or Up give all zeros
    ramp = np.arange(70, dtype=np.uint8)  # a ramp: Sub gives constants
    arr[10:20] = ramp[:, None] if channels else ramp
    data = png.encode_png(arr)
    bpp = max(channels, 1)
    rows = arr.reshape(arr.shape[0], -1).astype(np.int32)
    h, stride = rows.shape
    idat = b"".join(b for k, b in png._chunks(data, "x") if k == b"IDAT")
    got = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    for y in range(h):
        prev = rows[y - 1] if y else np.zeros(stride, np.int32)
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        cands = [(cur - pred) & 0xFF for pred in (
            0, left, prev, (left + prev) >> 1, paeth)]
        costs = [int(np.minimum(c, 256 - c).sum()) for c in cands]
        assert got[y, 0] == int(np.argmin(costs)), y
        np.testing.assert_array_equal(got[y, 1:], cands[got[y, 0]])
    assert set(got[:, 0].tolist()) >= {1, 2}
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  arr)
    for unfilter in ("native", "python"):
        np.testing.assert_array_equal(
            png.decode_png(data, unfilter=unfilter).pixels, arr)


def test_png_unfilter_builds_into_build_native():
    """The C++ unfilter is built by g++ at first use under build/native/."""
    assert png._load_native() is not None, png.native_error()
    png.decode_png(png.encode_png(_photo(9, 9, 1)))
    assert png.last_unfilter == "native"


def test_png_reader_refuses_what_it_cannot_read(tmp_path):
    """16-bit, 1-bit gray, interlaced, truncated and non-PNG input raise,
    naming the file."""
    p16 = str(tmp_path / "sixteen.png")
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 999
                    ).save(p16)
    with pytest.raises(ValueError, match="sixteen.png.*16-bit"):
        png.read_png(p16)
    p1 = str(tmp_path / "one.png")
    Image.fromarray(_photo(9, 9, 0) > 128).save(p1)  # PIL mode "1"
    with pytest.raises(ValueError, match="one.png.*1-bit L"):
        png.read_png(p1)
    good = png.encode_png(_photo(8, 8, 2))
    ihdr = bytearray(good[12:29])  # kind + body
    ihdr[16] = 1  # the interlace method
    interlaced = (good[:12] + bytes(ihdr)
                  + struct.pack(">I", zlib.crc32(bytes(ihdr))) + good[33:])
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        png.decode_png(interlaced, "interlaced.png")
    with pytest.raises(ValueError, match="bad CRC"):
        png.decode_png(good[:12] + bytes(ihdr) + good[29:], "crc.png")
    with pytest.raises(ValueError, match="cut.png"):
        png.decode_png(good[:40], "cut.png")
    with pytest.raises(ValueError, match="x.jpg: not a PNG"):
        png.decode_png(b"\xff\xd8" + good[2:], "x.jpg")
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 4), np.uint8))


# --- load_gray, image_size, sample_colors against the JAX package -----------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNG (gray and RGB), baseline and progressive JPEG, at odd and
    non-square sizes, some smaller than the target frame."""
    d = tmp_path_factory.mktemp("img")
    out = {}
    for i, (h, w, ch) in enumerate(((480, 640, 0), (301, 417, 3),
                                    (100, 60, 3), (97, 130, 0))):
        arr = _photo(h, w, RNG_SEED + i, ch)
        mode = "RGB" if ch else "L"
        out[f"png{i}"] = str(d / f"im{i}.png")
        Image.fromarray(arr, mode).save(out[f"png{i}"])
        out[f"jpg{i}"] = str(d / f"im{i}.jpg")
        Image.fromarray(arr, mode).save(out[f"jpg{i}"], quality=90)
        out[f"prog{i}"] = str(d / f"im{i}p.jpg")
        Image.fromarray(arr, mode).save(out[f"prog{i}"], quality=85,
                                        progressive=True)
    return out


RESIZES = [(832, 8, None), (256, 8, 256), (640, 16, 700), (200, 8, 832),
           (96, 8, 96)]


def _same_loaded(got, ref, atol):
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=atol)
    np.testing.assert_array_equal(got.scale, ref.scale)
    assert got.orig_size == ref.orig_size
    assert got.valid_size == ref.valid_size


@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("backend", ["png", "auto"])
def test_load_gray_png_equals_jax_native(files, i, backend):
    """PNG through each port backend against the JAX native loader, at
    several (long_side, df, pad_to); "auto" takes the png path."""
    for long_side, df, pad in RESIZES:
        ref = JI.load_gray(files[f"png{i}"], long_side, df, pad,
                           backend="native")
        got = TI.load_gray(files[f"png{i}"], long_side, df, pad,
                           backend=backend)
        _same_loaded(got, ref, 1e-6)
        assert TI.last_backend == "png"


@pytest.mark.parametrize("backend", ["jpeg", "auto"])
@pytest.mark.parametrize("kind", ["jpg", "prog"])
def test_load_gray_jpeg_equals_jax_native(files, kind, backend):
    """Baseline and progressive JPEG through the jpeg path, named or taken
    by "auto", against the JAX native loader (libjpeg): exact."""
    for i in range(4):
        for long_side, df, pad in RESIZES:
            ref = JI.load_gray(files[f"{kind}{i}"], long_side, df, pad,
                               backend="native")
            got = TI.load_gray(files[f"{kind}{i}"], long_side, df, pad,
                               backend=backend)
            _same_loaded(got, ref, 0.0)
            assert TI.last_backend == "jpeg"


def test_image_size_equals_pil(files):
    """From the header alone, for PNG, baseline and progressive JPEG."""
    for path in files.values():
        with Image.open(path) as im:
            assert TI.image_size(path) == im.size, path


def test_sample_colors_equal_jax(files):
    """Nearest-pixel colours as the JAX package's PIL path: PNG through
    "auto" and the png backend, JPEG through "auto"; points off the image
    clamp to its border."""
    rng = np.random.default_rng(RNG_SEED)
    for key, path in files.items():
        with Image.open(path) as im:
            w, h = im.size
        xy = rng.uniform(-5, 1.1 * max(w, h), (300, 2))
        ref = JI.sample_colors(path, xy)
        np.testing.assert_array_equal(TI.sample_colors(path, xy), ref)
        if key.startswith("png"):
            np.testing.assert_array_equal(
                TI.sample_colors(path, xy, backend="png"), ref)


def test_auto_without_the_native_loader(files):
    """With no system image library (the port has no libjpeg loader, as
    the card has no libjpeg), "auto" reads PNG with the png path and JPEG
    (baseline and progressive) with the jpeg path, equal to the JAX
    native loader and PIL; a backend named for the wrong format refuses
    the file."""
    got = TI.load_gray(files["png1"], 256, 8, 256)
    assert TI.last_backend == "png"
    _same_loaded(got, JI.load_gray(files["png1"], 256, 8, 256,
                                   backend="native"), 1e-6)
    for key in ("jpg1", "prog1"):
        got = TI.load_gray(files[key], 256, 8, 256)
        assert TI.last_backend == "jpeg"
        _same_loaded(got, JI.load_gray(files[key], 256, 8, 256,
                                       backend="native"), 0.0)
        xy = np.array([[0.0, 0.0], [40.5, 17.2], [1e4, 3.0]])
        np.testing.assert_array_equal(TI.sample_colors(files[key], xy),
                                      JI.sample_colors(files[key], xy))
    with pytest.raises(ValueError, match="not a PNG"):
        TI.load_gray(files["jpg1"], 256, 8, 256, backend="png")
    with pytest.raises(ValueError, match="not a JPEG"):
        TI.load_gray(files["png1"], 256, 8, 256, backend="jpeg")


@pytest.mark.parametrize("fmt", ["BMP", "TIFF", "GIF"])
def test_auto_refuses_neither_png_nor_jpeg(tmp_path, fmt):
    """A file that is neither PNG nor JPEG raises ValueError naming it,
    from load_gray and decode_rgb alike, before anything is decoded."""
    path = str(tmp_path / f"photo.{fmt.lower()}")
    Image.fromarray(_photo(24, 32, 5)).save(path, fmt)
    for read in (lambda: TI.load_gray(path, 64, 8, 64),
                 lambda: TI.decode_rgb(path)):
        TI.last_backend = None
        with pytest.raises(ValueError, match="neither PNG nor JPEG") as e:
            read()
        assert path in str(e.value)
        assert TI.last_backend is None


def test_native_backend_is_unknown(files):
    """The port has no "native" backend: naming it raises the unknown
    backend error, and BACKENDS lists the two decoders and "auto"."""
    assert TI.BACKENDS == ("auto", "png", "jpeg")
    for path in (files["png1"], files["jpg1"]):
        with pytest.raises(ValueError, match="unknown image backend"):
            TI.load_gray(path, 256, 8, 256, backend="native")
        with pytest.raises(ValueError, match="unknown image backend"):
            TI.decode_rgb(path, backend="native")


def test_auto_reads_alpha_png_that_native_refuses(tmp_path):
    """The JAX native loader refuses alpha PNGs (the JAX package then
    falls back to PIL); "auto" reads them with the png path, as PIL's
    convert("L") does (alpha ignored)."""
    arr = _photo(40, 50, 3, 4)
    path = str(tmp_path / "rgba.png")
    Image.fromarray(arr, "RGBA").save(path)
    got = TI.load_gray(path, 64, 8, 64)
    assert TI.last_backend == "png"
    ref = JI.load_gray(path, 64, 8, 64, backend="pil")
    # JAX's PIL path resizes in 8-bit fixed point: within ~1/255.
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=1.5 / 255)
    lum = np.asarray(Image.open(path).convert("L"), np.float32) / 255
    np.testing.assert_allclose(
        TI.resample_axis(TI.resample_axis(lum, 64, 1), 48, 0),
        got.data[:48, :64], rtol=0, atol=0)
