"""Image datasets (port of flashgmm_tpu/datasets/image.py; CompressAI's
compressai/datasets/image.py:38-60), numpy NHWC float32.

``ImageFolder`` expects ``root/train/*`` and ``root/test/*`` split
directories, as the reference does, and returns numpy [H, W, 3] float32 in
[0, 1].

Random crops draw from Python's global ``random``, as the JAX package's
do, so after one ``random.seed(s)`` both packages cut the same crops in the
same order. Neither trainer seeds ``random``, and ``BatchLoader``'s
threads crop in no fixed order, so crops repeat only with one worker.
"""

import random
from pathlib import Path

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def _read_ppm(path):
    """A binary PPM (P6) with maxval 255 as uint8 [H, W, 3], read with
    numpy; None for any other file."""
    data = Path(path).read_bytes()
    if data[:2] != b"P6":
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # a comment runs to the end of the line
            while data[pos:pos + 1] not in (b"\n", b"\r", b""):
                pos += 1
            continue
        start = pos
        while data[pos:pos + 1] and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    if maxval != 255:
        return None
    pos += 1  # the one whitespace byte before the raster
    return np.frombuffer(data, np.uint8, 3 * w * h, pos).reshape(h, w, 3)


def load_image(path):
    """[H, W, 3] float32 in [0, 1]. A binary PPM (P6, maxval 255) is read
    with numpy; every other file is opened through Pillow, imported only
    then (the JAX package opens every file through Pillow: the array is the
    same). So a folder of .ppm files needs no Pillow."""
    arr = _read_ppm(path) if Path(path).suffix.lower() == ".ppm" else None
    if arr is None:
        from PIL import Image

        arr = Image.open(path).convert("RGB")
    return np.asarray(arr, dtype=np.float32) / 255.0


def save_image(path, array):
    """array: [H, W, 3] float in [0, 1], rounded to 8 bits. A .ppm file is
    written as binary PPM with numpy, any other through Pillow."""
    arr = np.clip(np.asarray(array) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if Path(path).suffix.lower() == ".ppm":
        h, w = arr.shape[:2]
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (w, h))
            f.write(np.ascontiguousarray(arr).tobytes())
        return
    from PIL import Image

    Image.fromarray(arr).save(path)


class ImageFolder:
    """root/{split}/ image dataset with an optional random crop and
    transform."""

    def __init__(self, root, transform=None, patch_size=None, split="train"):
        splitdir = Path(root) / split
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{splitdir}"')
        self.samples = sorted(
            f for f in splitdir.iterdir()
            if f.suffix.lower() in IMG_EXTENSIONS
        )
        self.transform = transform
        self.patch_size = patch_size

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        img = load_image(self.samples[index])
        if self.patch_size is not None:
            img = random_crop(img, self.patch_size)
        if self.transform is not None:
            img = self.transform(img)
        return img


def random_crop(img, size):
    """Random spatial crop to (size, size), from Python's global ``random``;
    pads by reflection if the image is smaller."""
    h, w = img.shape[:2]
    if h < size or w < size:
        ph, pw = max(0, size - h), max(0, size - w)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    top = random.randint(0, h - size)
    left = random.randint(0, w - size)
    return img[top: top + size, left: left + size]


def center_crop(img, size):
    h, w = img.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return img[top: top + size, left: left + size]
