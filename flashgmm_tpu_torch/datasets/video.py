"""Video training datasets (port of flashgmm_tpu/datasets/video.py;
CompressAI's compressai/datasets/video.py), numpy [H, W, 3] float32 frames
read by ``datasets.image.load_image`` (a binary PPM with numpy, any other
file through Pillow).

``VideoFolder``: root/sequences/*/frames; samples random temporal windows.
``Vimeo90kDataset``: the vimeo_septuplet layout with a list file.

Crops, intervals and temporal flips draw from Python's global ``random``,
as the JAX package's do.
"""

import random
from pathlib import Path

from .image import IMG_EXTENSIONS, load_image


class VideoFolder:
    """root/<split>list.txt with one sequence-dir per line (or all subdirs
    of root/sequences); each item is a list of ``rnd_temp_order`` frames."""

    def __init__(self, root, rnd_interval=False, rnd_temp_order=False,
                 max_frames=3, patch_size=None, split="train", transform=None):
        root = Path(root)
        list_path = root / f"{split}list.txt"
        seq_root = root / "sequences"
        if list_path.is_file():
            with open(list_path) as f:
                self.sample_folders = [
                    seq_root / line.strip() for line in f if line.strip()
                ]
        elif seq_root.is_dir():
            self.sample_folders = sorted(p for p in seq_root.iterdir() if p.is_dir())
        else:
            raise RuntimeError(f'Invalid video dataset root "{root}"')
        self.max_frames = max_frames
        self.rnd_interval = rnd_interval
        self.rnd_temp_order = rnd_temp_order
        self.patch_size = patch_size
        self.transform = transform

    def __len__(self):
        return len(self.sample_folders)

    def __getitem__(self, index):
        folder = self.sample_folders[index]
        samples = sorted(
            f for f in folder.iterdir() if f.suffix.lower() in IMG_EXTENSIONS
        )
        max_interval = max(len(samples) // self.max_frames, 1)
        interval = random.randint(1, max_interval) if self.rnd_interval else 1
        frame_paths = samples[::interval][: self.max_frames]

        frames = [load_image(p) for p in frame_paths]
        if self.patch_size is not None:
            h, w = frames[0].shape[:2]
            size = self.patch_size
            top = random.randint(0, max(0, h - size))
            left = random.randint(0, max(0, w - size))
            frames = [f[top : top + size, left : left + size] for f in frames]
        if self.rnd_temp_order and random.random() < 0.5:
            frames = frames[::-1]
        if self.transform:
            frames = [self.transform(f) for f in frames]
        return frames


class Vimeo90kDataset:
    """vimeo_septuplet layout: root/sequences/xxxxx/yyyy/im{1..7}.png with
    sep_trainlist.txt / sep_testlist.txt."""

    def __init__(self, root, split="train", tuplet=3, patch_size=None,
                 transform=None):
        root = Path(root)
        list_file = root / f"sep_{'train' if split == 'train' else 'test'}list.txt"
        with open(list_file) as f:
            self.samples = [
                root / "sequences" / line.strip() for line in f if line.strip()
            ]
        self.tuplet = tuplet
        self.patch_size = patch_size
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        folder = self.samples[index]
        frames = [
            load_image(folder / f"im{i + 1}.png") for i in range(self.tuplet)
        ]
        if self.patch_size is not None:
            h, w = frames[0].shape[:2]
            size = self.patch_size
            top = random.randint(0, max(0, h - size))
            left = random.randint(0, max(0, w - size))
            frames = [f[top : top + size, left : left + size] for f in frames]
        if self.transform:
            frames = [self.transform(f) for f in frames]
        return frames
