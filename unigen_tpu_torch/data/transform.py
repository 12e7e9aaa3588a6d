"""Image preprocessing, without PIL.

The port's copy of ``unigen_tpu/data/transform.py``: ``image_transform``
(the loaders' short-side resize, centre crop and [-1, 1] scaling),
``pad_image``, ``naflex_target_dims`` (arithmetic, as it is),
``naflex_resize``, ``naflex_preprocess`` and ``siglip_preprocess``, with
JAX's rounding of every size and offset. JAX's versions resize with PIL's
``BICUBIC``; the card's machine has no PIL,
so these resize uint8 pixels on the host with ``F.interpolate(mode="bicubic",
antialias=True)``, which follows PIL's a = -0.5 kernel and rounding: on the
images of tests/test_torch_naflex.py the two differ by at most 2 levels on
under 1% of the values. A resize to the image's own size is the identity,
as PIL's is.

An image is a uint8 [H, W, 3] array (or tensor), a [H, W] grey one, or an
object with PIL's ``mode`` and ``convert`` (lmms-eval hands PIL images):
such an object is converted to RGB by its own method and read with
``np.asarray``, so PIL is never imported here. Outputs are numpy, NHWC.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def to_rgb_uint8(image) -> np.ndarray:
    """[H, W, 3] uint8 of a PIL-like image (by its ``convert("RGB")``) or of
    an array: grey becomes three equal channels, a fourth channel is dropped."""
    if hasattr(image, "mode") and hasattr(image, "convert"):
        image = image if image.mode == "RGB" else image.convert("RGB")
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected uint8 pixels, got {arr.dtype}")
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected an [H, W, 3] image, got {arr.shape}")
    return arr[:, :, :3]


def image_size(image) -> Tuple[int, int]:
    """(width, height) of a PIL-like image (its ``size``) or an array, read
    without touching the pixels."""
    if hasattr(image, "mode") and hasattr(image, "size") and not callable(image.size):
        return tuple(image.size)
    shape = image.shape
    return int(shape[1]), int(shape[0])


def resize_bicubic_uint8(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [height, width, 3] uint8, antialiased bicubic; the
    same size gives a copy."""
    if arr.shape[:2] == (height, width):
        return arr.copy()
    x = torch.from_numpy(np.require(arr, requirements=["C", "W"])).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bicubic", align_corners=False,
                      antialias=True)
    # the copy to HWC by numpy: torch's threaded copy of this strided uint8
    # view costs tens of times more on a host of several cores
    return np.ascontiguousarray(y[0].numpy().transpose(1, 2, 0))


def _normalize(arr: np.ndarray) -> np.ndarray:
    return (arr.astype(np.float32) / 255.0 - 0.5) / 0.5


def image_transform(image, resolution: int = 256, normalize: bool = True) -> np.ndarray:
    """Bicubic resize of the short side to ``resolution`` (the long side
    ``max(resolution, round(side * scale))``), centre crop at
    ``(size - resolution) // 2``, then ``x / 255`` and with ``normalize``
    ``(x - 0.5) / 0.5``: [resolution, resolution, 3] float32."""
    arr = to_rgb_uint8(image)
    h, w = arr.shape[:2]
    scale = resolution / min(w, h)
    nw, nh = max(resolution, round(w * scale)), max(resolution, round(h * scale))
    arr = resize_bicubic_uint8(arr, nh, nw)
    left, top = (nw - resolution) // 2, (nh - resolution) // 2
    x = arr[top:top + resolution, left:left + resolution].astype(np.float32) / 255.0
    if normalize:
        x = (x - 0.5) / 0.5
    return x


def pad_image(image, target_resolution: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving bicubic resize into ``target_resolution`` = (width,
    height), sizes ``int(side * scale)``, centred on zeros: uint8 [height,
    width, 3]."""
    arr = to_rgb_uint8(image)
    h, w = arr.shape[:2]
    tw, th = target_resolution
    scale = min(tw / w, th / h)
    nw, nh = int(w * scale), int(h * scale)
    canvas = np.zeros((th, tw, 3), np.uint8)
    top, left = (th - nh) // 2, (tw - nw) // 2
    canvas[top:top + nh, left:left + nw] = resize_bicubic_uint8(arr, nh, nw)
    return canvas


def naflex_target_dims(w: int, h: int, patch_size: int = 16,
                       max_num_patches: int = 256) -> tuple:
    """(target_h, target_w) of the NaFlex aspect-preserving resize: the largest
    patch-multiple dims within the patch budget, from the image's dims alone."""
    p = patch_size
    scale = (max_num_patches * p * p / (w * h)) ** 0.5
    th = max(p, int(round(h * scale / p)) * p)
    tw = max(p, int(round(w * scale / p)) * p)
    # rounding can overshoot the patch budget; shrink the longer side until it fits
    while (th // p) * (tw // p) > max_num_patches:
        if th >= tw and th > p:
            th -= p
        elif tw > p:
            tw -= p
        else:
            break
    return th, tw


def naflex_resize(image, patch_size: int = 16, max_num_patches: int = 256) -> np.ndarray:
    """Aspect-preserving resize to at most ``max_num_patches`` patches with
    patch-multiple dims, then ``(x / 255 - 0.5) / 0.5``: [th, tw, 3] float32."""
    arr = to_rgb_uint8(image)
    th, tw = naflex_target_dims(arr.shape[1], arr.shape[0], patch_size, max_num_patches)
    return _normalize(resize_bicubic_uint8(arr, th, tw))


def naflex_preprocess(image, patch_size: int = 16, max_num_patches: int = 256):
    """The SigLIP2-NaFlex processor: ``naflex_resize``, patchify, pad to
    ``max_num_patches``. Returns {'pixel_values': [maxP, 3*p*p] f32,
    'pixel_attention_mask': [maxP] int32, 'spatial_shapes': [2] int32 (h, w
    in patches)}."""
    x = naflex_resize(image, patch_size, max_num_patches)
    p = patch_size
    hp, wp = x.shape[0] // p, x.shape[1] // p
    patches = x.reshape(hp, p, wp, p, 3).transpose(0, 2, 1, 3, 4).reshape(hp * wp, -1)
    out = np.zeros((max_num_patches, patches.shape[-1]), np.float32)
    out[: patches.shape[0]] = patches
    mask = np.zeros((max_num_patches,), np.int32)
    mask[: patches.shape[0]] = 1
    return {"pixel_values": out, "pixel_attention_mask": mask,
            "spatial_shapes": np.asarray([hp, wp], np.int32)}


def siglip_preprocess(image, image_size: int = 384, as_uint8: bool = False) -> np.ndarray:
    """The SigLIP processor: resize to (size, size) bicubic, then
    ``(x / 255 - 0.5) / 0.5`` ([H, W, 3] float32); with ``as_uint8`` the
    resized uint8 pixels, which the pipeline normalizes on the device with
    the same fp32 operations."""
    arr = resize_bicubic_uint8(to_rgb_uint8(image), image_size, image_size)
    return arr if as_uint8 else _normalize(arr)
