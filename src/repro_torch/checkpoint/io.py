"""Checkpointing: npz shards plus a msgpack manifest. Counterpart of
``repro/checkpoint/io.py``, in its format: the port reads the reference's
checkpoints and the reference reads the port's.

Trees of dicts, lists, tuples and ``None`` are flattened to '/'-joined
paths, their leaves written as numpy arrays in npz shards of at most
``_SHARD_BYTES``, beside ``manifest.msgpack`` (tree structure, shard index,
step, extra). The manifest goes through ``packb``/``unpackb`` below: the
subset of msgpack that it uses (maps, arrays, str, int, bool, nil and bin),
written the way the ``msgpack`` package writes it, so that the port needs no
package beyond numpy and torch. A float32 or integer leaf round-trips; a
bfloat16 one is refused on save, and a leaf that ``np.load`` returns as a
void dtype (the reference's ml_dtypes bfloat16) on load.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.convert import to_tensor

_SHARD_BYTES = 512 * 1024 * 1024


# -- the manifest's msgpack subset ------------------------------------------------


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -0x20 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                  (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
                if obj <= top:
                    out.append(tag)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(f"int {obj} does not fit msgpack's 64 bits")
        else:
            for tag, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                  (0xD2, ">i", -0x80000000), (0xD3, ">q", -2 ** 63)):
                if obj >= low:
                    out.append(tag)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(f"int {obj} does not fit msgpack's 64 bits")
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the manifest codec takes dict, list, tuple, str, int, bool, "
                        f"None and bytes, not {type(obj).__name__}")


def _header(out: bytearray, n: int, fix, fix_limit: int, tags) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-, 16- or
    32-bit form among ``tags`` (None where the type has none)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the manifest's types."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: bytes, i: int):
    """-> (object, next offset)."""
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    if tag == 0xC0:
        return None, i
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, i
    if tag in _FIXED:
        fmt = _FIXED[tag]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag in _LENGTHS:
        kind, fmt = _LENGTHS[tag]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{tag:02x} at offset {i - 1} is outside "
                         "the manifest's subset")
    if kind in ("str", "bin"):
        if i + n > len(buf):
            raise ValueError("truncated msgpack data")
        raw = bytes(buf[i:i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    d = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        d[k], i = _unpack(buf, i)
    return d, i


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the manifest's types."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the msgpack object")
    return obj


# -- trees -------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix + "__none__"] = None
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _tree_structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict", "items": {k: _tree_structure(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_tree_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_tree_structure(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf"}


def _rebuild(struct_, leaves: dict, prefix=""):
    kind = struct_["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, leaves, f"{prefix}{k}/") for k, v in struct_["items"].items()}
    if kind in ("tuple", "list"):
        seq = [_rebuild(v, leaves, f"{prefix}{i}/") for i, v in enumerate(struct_["items"])]
        return tuple(seq) if kind == "tuple" else seq
    if kind == "none":
        return None
    return leaves[prefix.rstrip("/")]


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves are not saved: the port's trainers keep "
                            "float32 parameters")
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, tree, *, step: int = 0, extra: dict | None = None):
    """Writes ``tree`` (tensors or numpy arrays at the leaves) to ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items() if v is not None}
    shards, cur, cur_bytes = [], {}, 0
    for k, v in flat.items():
        cur[k] = v
        cur_bytes += v.nbytes
        if cur_bytes >= _SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
    if cur:
        shards.append(cur)
    index = {}
    for i, shard in enumerate(shards):
        fn = f"shard_{i:05d}.npz"
        np.savez(os.path.join(path, fn), **{k.replace("/", "|"): v for k, v in shard.items()})
        for k in shard:
            index[k] = fn
    manifest = {"step": step, "structure": _tree_structure(tree), "index": index,
                "extra": extra or {}}
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))


def load_checkpoint(path: str, *, device=None):
    """-> (tree of tensors on ``device`` (None: the GPU), step, extra)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    leaves = {}
    by_shard: dict[str, list[str]] = {}
    for k, fn in manifest["index"].items():
        by_shard.setdefault(fn, []).append(k)
    for fn, keys in by_shard.items():
        with np.load(os.path.join(path, fn)) as z:
            for k in keys:
                a = z[k.replace("/", "|")]
                if a.dtype.kind == "V":
                    raise TypeError(f"{k}: np.load gives the void dtype {a.dtype} (a "
                                    "bfloat16 leaf?); the port loads float and integer "
                                    "leaves only")
                leaves[k] = to_tensor(a).to(dev)
    return _rebuild(manifest["structure"], leaves), manifest["step"], manifest["extra"]
