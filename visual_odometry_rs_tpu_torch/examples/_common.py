"""Argument parsing shared by the example programs."""

from __future__ import annotations

import argparse
import os

import torch

from ..utils.types import resolve_device


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU, which must exist)")
    return p


def device_of(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else "cuda")


def image_or(path, make, device):
    """The u8 image at ``path`` (a PNG), or ``make()``, as a tensor on ``device``."""
    if path:
        from ..dataset.tum_rgbd import read_gray

        img = read_gray(path)
    else:
        img = make()
    return torch.from_numpy(img).to(device)


def shown(path: str) -> str:
    """A relative path as the JAX examples print it (``./out/...``)."""
    return path if os.path.isabs(path) or path.startswith(".") else "./" + path
