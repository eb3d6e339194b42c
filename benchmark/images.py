"""Seeded test images: COCO-typical shapes, made on the device in a few
large calls and written as JPEG files where a mix serves a directory."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch


def make(gen: torch.Generator, n: int, shapes, device) -> list:
    """``n`` (H, W, 3) uint8 images, image i of shape ``shapes[i % len]``:
    a coarse random field upsampled 32x plus N(0, 20) noise, clipped. One
    draw per shape for all its images."""
    out = [None] * n
    for si, (h, w) in enumerate(shapes):
        idx = list(range(si, n, len(shapes)))
        if not idx:
            continue
        coarse = torch.rand(len(idx), h // 32 + 1, w // 32 + 1, 3, generator=gen,
                            device=device)
        img = coarse.repeat_interleave(32, 1).repeat_interleave(32, 2)[:, :h, :w]
        noise = torch.randn(len(idx), h, w, 3, generator=gen, device=device)
        img = torch.clamp(img * 200.0 + noise * 20.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = img[j]
    return out


def write_jpegs(images, img_dir: str, quality: int) -> list:
    """Write each image as ``img{i:04d}.jpg``; returns the paths."""
    from PIL import Image

    os.makedirs(img_dir, exist_ok=True)
    paths = [os.path.join(img_dir, f"img{i:04d}.jpg") for i in range(len(images))]

    def save(pair):
        img, path = pair
        Image.fromarray(img).save(path, quality=quality)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(save, zip(images, paths)))
    return paths
