"""The port's JPEG decoder (csrc/jpeg.cpp behind data/images.py) against
libjpeg through the JAX package's native loader and against PIL, on the
committed fixtures of tests/data/torch/jpeg/ (tools/make_jpeg_fixtures.py).
Tolerance: none. Luma, resized frames, RGB, point colours and mean colours
are equal bit for bit."""

import glob
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from detectorfreesfm_tpu.data import images as JI
from detectorfreesfm_tpu_torch.data import images as TI

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch", "jpeg")
SMALL = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(JPEG_DIR, "small", "*.jpg")))
LARGE = ["scene/view_000.jpg", "scene/view_003.jpg", "photo_2080px_prog.jpg"]
# Two frames: an upscale of the small files into a padded square, and a
# non-square pad with df 16.
FRAMES = [(96, 8, 96), (40, 16, 48)]
REFUSED = {
    "arithmetic_sof9.jpg": r"arithmetic coding \(SOF9\) is not supported",
    "cmyk.jpg": r"CMYK/YCCK \(4 components\) is not supported",
    "adobe_rgb.jpg": "Adobe RGB without the colour transform",
    "truncated_base.jpg": "truncated file",
    "truncated_prog.jpg": "truncated file",
    "huffman_oversubscribed.jpg": "corrupt Huffman table",
    "huffman_all_ones.jpg": "corrupt Huffman table",
}


def _small(name):
    return os.path.join(JPEG_DIR, "small", name)


def _same_loaded(got, ref):
    assert np.array_equal(got.data, ref.data)
    assert np.array_equal(got.scale, ref.scale)
    assert got.orig_size == ref.orig_size
    assert got.valid_size == ref.valid_size


def _scans(path):
    """(marker, Ns, Ss, Se, Ah, Al) of each frame and scan header, and the
    restart interval, read from the file's marker segments."""
    with open(path, "rb") as f:
        data = f.read()
    i, scans, dri, frame = 2, [], 0, None
    while i + 4 <= len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF) or \
                0xD0 <= data[i + 1] <= 0xD7:
            i += 1
            continue
        m = data[i + 1]
        if m == 0xD9:
            break
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if m == 0xDA:
            ns = data[i + 4]
            ss, se, a = data[i + 5 + 2 * ns:i + 8 + 2 * ns]
            scans.append((ns, ss, se, a >> 4, a & 15))
        elif m == 0xDD:
            dri = struct.unpack(">H", data[i + 4:i + 6])[0]
        elif m in (0xC0, 0xC2):
            nf = data[i + 9]
            frame = (m, nf, tuple(data[i + 11 + 3 * k] for k in range(nf)))
        i += 2 + n
    return frame, scans, dri


def test_fixtures_cover_what_the_decoder_reads():
    """The committed files hold what the decoder must read: gray and YCbCr
    at 4:4:4, 4:2:2 and 4:2:0, baseline and progressive frames whose scans
    refine by successive approximation (DC and AC), restart intervals and
    odd sizes; and the whole folder stays small."""
    sampling, progressive, refined_ac, refined_dc, restarts = (
        set(), 0, 0, 0, 0)
    for name in SMALL:
        frame, scans, dri = _scans(_small(name))
        sampling.add(frame[2])
        progressive += frame[0] == 0xC2
        refined_ac += any(s[3] > 0 and s[1] > 0 for s in scans)
        refined_dc += any(s[3] > 0 and s[1] == 0 for s in scans)
        restarts += dri > 0
    assert sampling >= {(0x11,), (0x11, 0x11, 0x11), (0x21, 0x11, 0x11),
                        (0x22, 0x11, 0x11)}, sampling
    assert progressive == len(SMALL) // 2 and restarts == len(SMALL) // 2
    assert refined_ac == refined_dc == progressive
    sizes = {Image.open(_small(n)).size for n in SMALL}
    assert sizes == {(1, 1), (17, 9), (67, 45)}
    total = sum(os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(JPEG_DIR) for f in fs)
    assert total <= 3 * 2**20, total


@pytest.mark.parametrize("name", SMALL)
def test_load_gray_equals_jax_native(name):
    """"auto" and "jpeg" against libjpeg's JCS_GRAYSCALE output through
    the JAX package's native loader, at two frames: bit for bit."""
    path = _small(name)
    for long_side, df, pad in FRAMES:
        ref = JI.load_gray(path, long_side, df, pad, backend="native")
        for backend in ("auto", "jpeg"):
            _same_loaded(TI.load_gray(path, long_side, df, pad,
                                      backend=backend), ref)
            assert TI.last_backend == "jpeg"


@pytest.mark.parametrize("name", SMALL)
def test_decode_rgb_equals_pil(name):
    """decode_rgb against PIL's convert("RGB") (libjpeg's fancy upsampling
    and YCbCr tables; gray files replicated): bit for bit."""
    path = _small(name)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
    got = TI.decode_rgb(path)
    assert TI.last_backend == "jpeg"
    assert got.dtype == np.uint8 and np.array_equal(got, ref)


@pytest.mark.parametrize("name", LARGE)
def test_large_files_equal_jax_and_pil(name):
    """Run J's views (baseline 4:2:0 and progressive, 1040 px) and the
    2080 px colour progressive file: load_gray at the 832 px frame equals
    the JAX native loader's, decode_rgb PIL's, and resizing the decoded
    luma with the numpy resample_axis gives the C++ resize's floats."""
    path = os.path.join(JPEG_DIR, name)
    got = TI.load_gray(path, 832, 8, 832)
    _same_loaded(got, JI.load_gray(path, 832, 8, 832, backend="native"))
    with Image.open(path) as im:
        assert np.array_equal(TI.decode_rgb(path),
                              np.asarray(im.convert("RGB")))
    luma = TI._jpeg_plane(path, rgb=False).astype(np.float32) / np.float32(
        255.0)
    nw, nh = got.valid_size
    numpy_resized = TI.resample_axis(TI.resample_axis(luma, nw, axis=1), nh,
                                     axis=0)
    assert np.array_equal(numpy_resized, got.data[:nh, :nw])


def test_sample_colors_and_mean_color_equal_jax():
    """Nearest-pixel colours (points off the image clamp) and mean colours
    as the JAX package's PIL path, on every small file and run J's
    progressive view."""
    rng = np.random.default_rng(3)
    for path in [_small(n) for n in SMALL] + [
            os.path.join(JPEG_DIR, "scene", "view_003.jpg")]:
        w, h = TI.image_size(path)
        xy = rng.uniform(-3, 1.1 * max(w, h) + 2, (200, 2))
        assert np.array_equal(TI.sample_colors(path, xy),
                              JI.sample_colors(path, xy)), path
        assert np.array_equal(TI.load_rgb_mean_color(path),
                              JI.load_rgb_mean_color(path)), path


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refuses_what_it_cannot_read(name):
    """Arithmetic coding (a baseline frame marker rewritten to SOF9),
    CMYK, RGB without the colour transform, files cut short and Huffman
    tables whose codes overflow their lengths raise, naming the file and
    the feature, from load_gray and decode_rgb. libjpeg (PIL) refuses the
    two Huffman tables too."""
    path = os.path.join(JPEG_DIR, "refused", name)
    for call in (lambda: TI.load_gray(path, 64, 8, 64),
                 lambda: TI.decode_rgb(path)):
        with pytest.raises(ValueError, match=f"{name}: {REFUSED[name]}"):
            call()
    if name.startswith("huffman_"):
        with pytest.raises(OSError), Image.open(path) as im:
            im.convert("RGB")


def test_thread_pool_gives_the_serial_result():
    """The engine's 8-thread pool decodes every fixture to the serial
    result (ctypes releases the GIL; the decoder holds no shared state)."""
    paths = [_small(n) for n in SMALL] + [os.path.join(JPEG_DIR, n)
                                          for n in LARGE]

    def load(p):
        return TI.load_gray(p, 256, 8, 256).data, TI.decode_rgb(p)

    serial = [load(p) for p in paths]
    with ThreadPoolExecutor(max_workers=8) as pool:
        pooled = list(pool.map(load, paths * 2))
    for (g, c), (pg, pc) in zip(serial * 2, pooled):
        assert np.array_equal(g, pg) and np.array_equal(c, pc)


SANITIZED_DRIVER = r"""
#include <cstdint>
#include <vector>
extern "C" {
int jpeg_gray(const char*, uint8_t*, long, int*, char*, int);
int jpeg_rgb(const char*, uint8_t*, long, int*, char*, int);
int jpeg_gray_resize(const char*, int, int, int, float*, int*, char*, int);
}
int main(int argc, char** argv) {
  std::vector<uint8_t> buf(1 << 20);
  std::vector<float> frame(64 * 64);
  int wh[2], meta[4];
  char err[256];
  for (int i = 1; i < argc; ++i) {
    jpeg_gray(argv[i], buf.data(), buf.size(), wh, err, sizeof(err));
    jpeg_rgb(argv[i], buf.data(), buf.size(), wh, err, sizeof(err));
    jpeg_gray_resize(argv[i], 64, 8, 64, frame.data(), meta, err,
                     sizeof(err));
  }
  return 0;
}
"""


def _mutations(paths, n, seed):
    """`n` corrupt copies of the files: bytes overwritten, flipped, cut,
    inserted or the file truncated, mostly in the headers (before the
    first scan's data), where the tables are."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        data = bytearray(open(paths[rng.integers(len(paths))], "rb").read())
        sos = data.find(b"\xff\xda")
        for _ in range(rng.integers(1, 7)):
            hi = min(sos + 12 if sos > 0 and rng.random() < 0.7
                     else len(data), len(data))
            if hi < 3:
                break
            i = int(rng.integers(2, hi))
            op = rng.random()
            if op < 0.6:
                data[i] = int(rng.integers(256))
            elif op < 0.75:
                data[i] ^= 1 << int(rng.integers(8))
            elif op < 0.85:
                del data[i:i + int(rng.integers(1, 9))]
            elif op < 0.95:
                data[i:i] = rng.integers(0, 256, int(rng.integers(1, 9)),
                                         dtype=np.uint8).tobytes()
            else:
                del data[i:]
        out.append(bytes(data))
    return out


def test_decoder_is_memory_safe_under_sanitizers(tmp_path):
    """csrc/jpeg.cpp built with AddressSanitizer and UndefinedBehavior-
    Sanitizer (any report aborts) reads every fixture and 400 seeded
    corruptions of the small and refused ones through all three entry
    points: no out-of-bounds access, no signed overflow."""
    import subprocess

    exe = tmp_path / "decode"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
         "-o", str(exe), "-x", "c++", "-", str(TI.JPEG_SOURCE)],
        input=SANITIZED_DRIVER, text=True, check=True, timeout=120)
    small = [_small(n) for n in SMALL] + sorted(
        glob.glob(os.path.join(JPEG_DIR, "refused", "*.jpg")))
    files = small + [os.path.join(JPEG_DIR, n) for n in LARGE[:1]]
    for k, data in enumerate(_mutations(small, 400, seed=11)):
        files.append(str(tmp_path / f"m{k:03d}.jpg"))
        with open(files[-1], "wb") as f:
            f.write(data)
    r = subprocess.run([str(exe)] + files, capture_output=True, text=True,
                       timeout=300,
                       env=dict(os.environ, ASAN_OPTIONS="detect_leaks=0"))
    assert r.returncode == 0 and "runtime error" not in r.stderr, \
        r.stderr[-3000:]


def test_decoder_builds_from_standard_cpp_alone():
    """csrc/jpeg.cpp builds with g++ and no library into build/native/ and
    includes no system image header."""
    assert TI._load_jpeg() is not None, TI.jpeg_error()
    path = TI.jpeg_library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    with open(TI.JPEG_SOURCE) as f:
        includes = [ln.split()[1] for ln in f if ln.startswith("#include")]
    assert set(includes) <= {"<algorithm>", "<cmath>", "<cstdint>",
                             "<cstdio>", "<cstring>", "<string>",
                             "<vector>"}, includes


def test_backend_names_and_routing(tmp_path):
    """"jpeg" refuses a PNG and "png" a JPEG; an unknown name raises."""
    png_path = str(tmp_path / "a.png")
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(png_path)
    with pytest.raises(ValueError, match="a.png: not a JPEG"):
        TI.load_gray(png_path, 64, 8, 64, backend="jpeg")
    with pytest.raises(ValueError, match="not a PNG"):
        TI.load_gray(_small(SMALL[0]), 64, 8, 64, backend="png")
    with pytest.raises(ValueError, match="unknown image backend"):
        TI.load_gray(png_path, backend="pil")
    TI.load_gray(png_path, 64, 8, 64)
    assert TI.last_backend == "png"
