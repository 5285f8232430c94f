#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's tests and GPU smoke test with PIL.

    python tools/make_jpeg_fixtures.py [--out tests/data/torch/jpeg]

Needs PIL (and its libjpeg); the machines that read the files need
neither. Writes, all from fixed seeds:

  * small/: the decoder's matrix: gray, 4:4:4, 4:2:2 and 4:2:0 at
    1x1, 17x9 and 67x45 (W x H), baseline and progressive (libjpeg's
    standard progression, with successive approximation), qualities 50
    and 95; the quality-50 files carry a restart marker after every MCU;
  * refused/: an arithmetic-coded frame (a baseline file's SOF0 marker
    rewritten to SOF9), CMYK, RGB stored without the colour transform
    (an Adobe marker with transform 0), a baseline and a progressive
    file cut short, and two baseline files whose first Huffman table
    (DC, luma) has its code counts rewritten: over-subscribed (three
    codes of length 1) and complete, ending in an all-ones code (one code
    of each length 1-10, two of length 11), both of which libjpeg refuses;
  * scene/: the four 1040 px renders of the GPU smoke test's run A scene,
    generate_scene(seed=0, size=1040, n_views=4), as 3-component YCbCr
    at quality 90, views 0-2 baseline 4:2:0 and view 3 progressive (the
    poses and intrinsics are written at run time, as chip_smoke.write_scene
    writes them);
  * photo_2080px_prog.jpg: a 2080 px colour progressive JPEG (2x2 tiles of
    three of those views as its colour channels) for the decode time of a
    photograph-sized file.
"""

import argparse
import io
import os
import sys

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((1, 1), (17, 9), (67, 45))  # (W, H)
KINDS = {"gray": None, "444": 0, "422": 1, "420": 2}  # PIL subsampling
QUALITIES = (50, 95)
SCENE_SIZE, SCENE_VIEWS = 1040, 4


def _photo(h, w, seed, colour):
    """A smooth image with noise and, for colour, channels that differ."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 90 * np.sin(xx / 5.0 + seed) * np.cos(yy / 7.0)
    a = base + rng.normal(0, 25, (h, w))
    if colour:
        a = np.stack([np.roll(a, 2 * c, axis=1) + 50 * c * np.sin(yy / 3.0)
                      for c in range(3)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def _save(img, path, **kw):
    img.save(path, "JPEG", **kw)
    return path


def small(out):
    d = os.path.join(out, "small")
    os.makedirs(d, exist_ok=True)
    for (w, h) in SIZES:
        for kind, sub in KINDS.items():
            arr = _photo(h, w, w * h + len(kind), sub is not None)
            img = Image.fromarray(arr, "L" if sub is None else "RGB")
            for prog in (False, True):
                for q in QUALITIES:
                    kw = dict(quality=q, progressive=prog)
                    if sub is not None:
                        kw["subsampling"] = sub
                    if q == 50:
                        kw["restart_marker_blocks"] = 1
                    name = (f"{kind}_{w}x{h}_q{q}_"
                            f"{'prog' if prog else 'base'}.jpg")
                    _save(img, os.path.join(d, name), **kw)


def refused(out):
    d = os.path.join(out, "refused")
    os.makedirs(d, exist_ok=True)
    img = Image.fromarray(_photo(40, 56, 1, True), "RGB")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90)
    base = buf.getvalue()
    i = base.index(b"\xff\xc0")
    with open(os.path.join(d, "arithmetic_sof9.jpg"), "wb") as f:
        f.write(base[:i + 1] + b"\xc9" + base[i + 2:])
    _save(img.convert("CMYK"), os.path.join(d, "cmyk.jpg"), quality=90)
    _save(img, os.path.join(d, "adobe_rgb.jpg"), quality=90, keep_rgb=True)
    with open(os.path.join(d, "truncated_base.jpg"), "wb") as f:
        f.write(base[: len(base) * 3 // 5])
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, progressive=True)
    prog = buf.getvalue()
    with open(os.path.join(d, "truncated_prog.jpg"), "wb") as f:
        f.write(prog[: len(prog) * 7 // 10])
    i = base.index(b"\xff\xc4") + 5  # marker, length, class and id
    n = sum(base[i:i + 16])  # 12 values in the standard table
    for name, counts in (("huffman_oversubscribed.jpg", [3, n - 3]),
                         ("huffman_all_ones.jpg", [1] * (n - 2) + [2])):
        counts += [0] * (16 - len(counts))
        with open(os.path.join(d, name), "wb") as f:
            f.write(base[:i] + bytes(counts) + base[i + 16:])


def scene(out):
    sys.path.insert(0, REPO)
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)

    d = os.path.join(out, "scene")
    os.makedirs(d, exist_ok=True)
    imgs = generate_scene(0, SyntheticConfig(size=SCENE_SIZE,
                                             n_views=SCENE_VIEWS))[0]
    views = []
    for i, im in enumerate(imgs):
        g = np.clip(np.round(im * 255.0), 0, 255).astype(np.uint8)
        views.append(g)
        rgb = Image.fromarray(np.repeat(g[..., None], 3, -1), "RGB")
        _save(rgb, os.path.join(d, f"view_{i:03d}.jpg"), quality=90,
              subsampling=2, progressive=i == SCENE_VIEWS - 1)
    rgb = np.tile(np.stack(views[:3], -1), (2, 2, 1))
    _save(Image.fromarray(rgb, "RGB"),
          os.path.join(out, "photo_2080px_prog.jpg"), quality=85,
          progressive=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch", "jpeg"))
    args = ap.parse_args()
    small(args.out)
    refused(args.out)
    scene(args.out)
    total = sum(os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
