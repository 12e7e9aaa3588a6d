"""Model persistence in the JAX package's format: config.json + safetensors.

Port of ``unigen_tpu/utils/persistence.py``. A checkpoint directory holds
``config.json`` and either ``model.safetensors`` or the shards
``model-0000i-of-0000n.safetensors`` with ``model.safetensors.index.json``;
tensors are stored under the ``/``-joined paths of JAX's parameter trees
(dict keys in sorted order, list indices as numbers), so the two packages
read each other's files. The trees here are in that JAX layout, with tensor
leaves: ``weights.unigen_to_jax`` and its siblings take the port's
parameters there, and ``weights.unigen_from_jax`` brings them back.

The port does not depend on the ``safetensors`` package, so the format is
written and read here: an 8-byte little-endian header length, a JSON header
``{name: {dtype, shape, data_offsets}}`` (plus ``__metadata__``), then the
raw little-endian bytes of every tensor. ``load_state_dict`` also reads the
reference / HF torch layouts' files for ``utils/hf_import.py``; with
``mmap=True`` its safetensors tensors are views of a private memory map of
each file (``map_file``), so a caller that copies a slice reads little more
than the slice.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import mmap as _mmap
import os
import struct
import sys
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

MAX_SHARD_BYTES = 10 * 1024 ** 3
WEIGHTS_NAME = "model.safetensors"
INDEX_NAME = "model.safetensors.index.json"
CONFIG_NAME = "config.json"

DTYPES = {"F64": torch.float64, "F32": torch.float32, "BF16": torch.bfloat16,
          "F16": torch.float16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_CODES = {v: k for k, v in DTYPES.items()}
if sys.byteorder != "little":
    raise ImportError("safetensors files are little-endian; this host is not")


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in JAX's flattening order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """One safetensors file of ``tensors`` (in their order), written one
    tensor at a time: the host holds one tensor's bytes, not the file's."""
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code")
        nb = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nb]}
        offset += nb
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)          # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(_bytes(t))


def tensor_names(path: str) -> list:
    """The tensor names in one safetensors file's header, in its order."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        if n > os.path.getsize(path) - 8:
            raise ValueError(f"{path}: header of {n} bytes past the end of the file")
        return [k for k in json.loads(f.read(n)) if k != "__metadata__"]


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, on the CPU, after checking the
    header against the file's size."""
    data = bytearray(os.path.getsize(path))        # read once, into the tensors' buffer
    with open(path, "rb") as f:
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: shorter than its size")
    return _tensors(data, path)


def map_file(path: str) -> Dict[str, torch.Tensor]:
    """``load_file``'s tensors as views of a private, copy-on-write memory
    map of the file: a page is read when a caller first touches it, and
    nothing is written back."""
    if os.path.getsize(path) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    with open(path, "rb") as f:
        return _tensors(_mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_COPY), path)


def _tensors(data, path: str) -> Dict[str, torch.Tensor]:
    """{name: view of ``data``} of one safetensors file's bytes, after
    checking the header against their size."""
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    n = struct.unpack("<Q", bytes(data[:8]))[0]
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes past the end of the file")
    header = json.loads(bytes(data[8:8 + n]))
    base, size = 8 + n, len(data) - 8 - n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has the unsupported dtype {info['dtype']}")
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        a, b = info["data_offsets"]
        numel = 1
        for d in shape:
            numel *= d
        if not 0 <= a <= b <= size or b - a != numel * dtype.itemsize:
            raise ValueError(f"{path}: {name}'s offsets {a}..{b} do not hold {shape} {dtype}")
        out[name] = (torch.frombuffer(data, dtype=dtype, count=numel, offset=base + a)
                     .reshape(shape) if numel else torch.empty(shape, dtype=dtype))
    return out


def load_state_dict(path: str, mmap: bool = False) -> Dict[str, torch.Tensor]:
    """A file, or a directory's weights -> {name: CPU tensor}: through the
    shard index when there is one (``model.safetensors.index.json`` or
    ``pytorch_model.bin.index.json``), else every ``*.safetensors``, else
    every ``pytorch_model*.bin`` (a pickled state dict, read by ``torch.load``
    with ``weights_only``: no code from the file runs). ``mmap``: the
    safetensors' tensors are ``map_file``'s views."""
    if os.path.isfile(path):
        files = [path]
    else:
        index = sorted(glob.glob(os.path.join(path, "*.index.json")))
        if index:
            with open(index[0]) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted({os.path.join(path, fn) for fn in weight_map.values()})
        else:
            files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
            if not files:
                files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
        if not files:
            raise FileNotFoundError(f"no weight files under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for fn in files:
        sd.update((map_file if mmap else load_file)(fn) if fn.endswith(".safetensors") else
                  torch.load(fn, map_location="cpu", weights_only=True))
    return sd


def take(sd: Dict[str, torch.Tensor], name: str, device, dtype) -> torch.Tensor:
    """``sd[name]`` on ``device`` in ``dtype``, contiguous; a name the state
    dict lacks raises ``KeyError`` naming it."""
    if name not in sd:
        raise KeyError(f"the checkpoint has no tensor {name!r}")
    return sd[name].to(device=device, dtype=dtype).contiguous()


def _flatten_cfg(cfg: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in cfg.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten_cfg(v, key))
        else:
            out[key] = v
    return out


def _config_value(v) -> str:
    """A config value JSON has no type for, as text. A dtype is spelt as the
    JAX package's writer spells it (``str`` of the ``jax.numpy`` type), so
    the two packages write the same ``config.json`` for the same config."""
    if isinstance(v, torch.dtype):
        return f"<class 'jax.numpy.{str(v).split('.', 1)[1]}'>"
    return str(v)


def save_pretrained(params: Any, save_dir: str, config: Optional[Any] = None,
                    max_shard_bytes: int = MAX_SHARD_BYTES) -> None:
    """Write config.json and the safetensors of a JAX-layout tree of tensors,
    in shards of at most ``max_shard_bytes`` (a larger tensor has a shard of
    its own), as JAX's ``save_pretrained`` does."""
    os.makedirs(save_dir, exist_ok=True)
    if config is not None:
        cfg = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
        cfg = {k: (_config_value(v) if not isinstance(v, (int, float, bool, str, list, dict,
                                                          tuple, type(None))) else v)
               for k, v in _flatten_cfg(cfg).items()}
        with open(os.path.join(save_dir, CONFIG_NAME), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
    flat = dict(_leaves(params))
    shards, current, size = [], {}, 0
    for key, t in flat.items():
        nb = t.numel() * t.element_size()
        if current and size + nb > max_shard_bytes:
            shards.append(current)
            current, size = {}, 0
        current[key] = t
        size += nb
    if current:
        shards.append(current)
    if len(shards) == 1:
        save_file(shards[0], os.path.join(save_dir, WEIGHTS_NAME))
        return
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, os.path.join(save_dir, name))
        for k in shard:
            weight_map[k] = name
    with open(os.path.join(save_dir, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": sum(t.numel() * t.element_size()
                                                  for t in flat.values())},
                   "weight_map": weight_map}, f, indent=2)


def _unflatten(flat: Dict[str, torch.Tensor], template: Any, prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(flat, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten(flat, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(template)]
    if template is None:
        return None
    if prefix not in flat:
        raise KeyError(f"checkpoint missing tensor {prefix}")
    t = flat[prefix]
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"{prefix}: shape {tuple(t.shape)} != expected {tuple(template.shape)}")
    return t.to(template.dtype)


def from_pretrained(save_dir: str, template: Any) -> Tuple[Any, Optional[Dict]]:
    """Load a checkpoint into the structure, shapes and dtypes of
    ``template`` (a JAX-layout tree of tensors, e.g. on the ``meta``
    device); returns (tree of CPU tensors, config or None)."""
    flat = load_state_dict(save_dir)
    cfg = None
    cfg_path = os.path.join(save_dir, CONFIG_NAME)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    return _unflatten(flat, template), cfg
