"""Weights from the JAX package into the port.

`state_dict_from_jax` maps the JAX model's variables — the
``{"params": ..., "batch_stats": ...}`` tree as nested dicts of numpy
arrays, which ``jax.device_get`` or the JAX serialization's
``to_state_dict`` gives — onto the port's ``state_dict``. The port names
its submodules after the JAX module names, so the mapping is
mechanical:

* a Dense ``kernel`` (in, out) becomes ``nn.Linear.weight`` (out, in);
* a Dense or BatchNorm ``bias`` stays ``bias``;
* BatchNorm and LayerNorm ``scale`` becomes ``weight``; BatchNorm
  ``mean`` and ``var`` become ``running_mean`` and ``running_var``;
* an attention projection (GroupFree3D's decoder) is one
  ``nn.Linear(288, 288)``: the ``query``, ``key`` and ``value`` kernels
  (in, heads, head_dim) are reshaped to (in, heads * head_dim) and
  transposed, their biases (heads, head_dim) flattened; the ``out``
  kernel (heads, head_dim, out) is reshaped to (heads * head_dim, out)
  and transposed;
* a list of submodules, which the JAX package names ``decoder_0``,
  ``prediction_heads_1``, ..., is an ``nn.ModuleList`` in the port:
  a name segment ``name_i`` (``i`` a number) becomes ``name.i``. No
  other module of either model ends its name in ``_`` and a number.

`read_jax_checkpoint` reads the checkpoints the JAX package's
``train/common.py::save_checkpoint`` writes (msgpack, gzipped or not)
with no package beyond numpy: `load_msgpack` decodes the subset of
msgpack that the JAX serialization writes, with its extension types
(1: an ndarray as ``(shape, dtype name, bytes)``, 3: a numpy scalar) and
its chunked arrays.
"""

from __future__ import annotations

import collections
import collections.abc
import gzip
import pathlib
import re
import struct

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_LIST_ITEM = re.compile(r"^(.+)_(\d+)$")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, collections.abc.Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX variables tree -> the port's state_dict (CPU tensors)."""
    out = collections.OrderedDict()
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES)):
        for path, value in _flatten(variables.get(collection, {})):
            *module, leaf = path
            if leaf not in leaves:
                raise KeyError(f"unmapped {collection} leaf"
                               f" {'/'.join(path)}")
            arr = np.asarray(value)
            if leaf == "kernel" and arr.ndim == 3:  # attention
                arr = (arr.reshape(-1, arr.shape[-1]) if module[-1] == "out"
                       else arr.reshape(arr.shape[0], -1))
            if leaf == "kernel":
                arr = arr.T
            elif leaf == "bias" and arr.ndim == 2:  # attention (heads, dim)
                arr = arr.reshape(-1)
            module = [_LIST_ITEM.sub(r"\1.\2", m) for m in module]
            name = ".".join([*module, leaves[leaf]])
            out[name] = torch.from_numpy(np.array(arr, order="C"))
    return out


# ---------------------------------------------------------------------------
# msgpack, as the JAX package's serialization writes it
# ---------------------------------------------------------------------------

_GZIP_MAGIC = b"\x1f\x8b"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# first byte -> (struct format of the length or value that follows, kind)
_HEADS = {
    0xc4: ("B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xc7: ("B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
    0xca: (">f", "value"), 0xcb: (">d", "value"),
    0xcc: ("B", "value"), 0xcd: (">H", "value"), 0xce: (">I", "value"),
    0xcf: (">Q", "value"), 0xd0: ("b", "value"), 0xd1: (">h", "value"),
    0xd2: (">i", "value"), 0xd3: (">q", "value"),
    0xd9: ("B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(buf: bytes, pos: int, raw: bool):
    """The object at `pos` and the position after it. With `raw`, str
    comes back as bytes (the inner encoding of an ndarray)."""
    head = buf[pos]
    pos += 1
    if head <= 0x7f:
        return head, pos
    if head >= 0xe0:
        return head - 0x100, pos
    if head <= 0x8f:
        kind, n = "map", head & 0x0f
    elif head <= 0x9f:
        kind, n = "array", head & 0x0f
    elif head <= 0xbf:
        kind, n = "str", head & 0x1f
    elif head in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[head], pos
    elif head in _FIXEXT:
        kind, n = "ext", _FIXEXT[head]
    elif head in _HEADS:
        fmt, kind = _HEADS[head]
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += struct.calcsize(fmt)
        if kind == "value":
            return n, pos
    else:
        raise ValueError(f"msgpack: unknown type byte 0x{head:02x} at"
                         f" {pos - 1}")
    if kind == "map":
        out = {}
        for _ in range(n):
            key, pos = _decode(buf, pos, raw)
            out[key], pos = _decode(buf, pos, raw)
        return out, pos
    if kind == "array":
        out = []
        for _ in range(n):
            item, pos = _decode(buf, pos, raw)
            out.append(item)
        return out, pos
    if kind == "ext":
        (code,) = struct.unpack_from("b", buf, pos)
        pos += 1
        return _ext(code, buf[pos:pos + n]), pos + n
    data = buf[pos:pos + n]
    if len(data) != n:
        raise ValueError("msgpack: truncated input")
    if kind == "str" and not raw:
        data = data.decode("utf-8")
    return data, pos + n


def _ext(code: int, data: bytes):
    """The extension types: an ndarray (1) or a numpy scalar (3)."""
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported extension type {code}")
    (shape, dtype, buffer), end = _decode(data, 0, raw=True)
    if end != len(data):
        raise ValueError("msgpack: trailing bytes in an ndarray")
    if dtype == b"bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not supported")
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype.decode())).reshape(
        shape, order="C")
    return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """Chunked arrays (``{"__msgpack_chunked_array__": True,
    "shape": {"0": ...}, "chunks": {"0": ...}}``) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)]
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_msgpack(path):
    """The tree in a msgpack checkpoint file of the JAX package (gzipped
    or not), as its serialization's ``msgpack_restore`` gives it: dicts,
    lists, Python scalars and read-only numpy arrays."""
    blob = pathlib.Path(path).read_bytes()
    if blob[:2] == _GZIP_MAGIC:
        blob = gzip.decompress(blob)
    try:
        tree, end = _decode(blob, 0, raw=False)
    except (IndexError, struct.error) as e:
        raise ValueError(f"{path}: truncated msgpack") from e
    if end != len(blob):
        raise ValueError(f"{path}: {len(blob) - end} bytes after the"
                         " msgpack object")
    return _unchunk(tree)


def read_jax_checkpoint(path):
    """A JAX package checkpoint (``train/common.py::save_checkpoint``)
    -> (variables ``{"params", "batch_stats"}``, epoch). The variables
    feed `state_dict_from_jax`."""
    payload = load_msgpack(path)
    if not (isinstance(payload, dict) and "state" in payload):
        raise ValueError(f"{path}: not a JAX package checkpoint")
    state = payload["state"]
    variables = {"params": state["params"],
                 "batch_stats": state.get("batch_stats", {})}
    return variables, int(payload["epoch"])
