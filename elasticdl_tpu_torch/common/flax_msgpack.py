"""The flax msgpack format, written and read without msgpack or flax.

`flax.serialization.to_bytes` of a nested dict of arrays (what the JAX
package's exporter writes) is a msgpack map with str keys, in
insertion order at every level, whose array leaves are msgpack ext type 1: a msgpack
array (shape, dtype name, raw C-order bytes) packed with bin types.
This module writes and reads that subset byte for byte:

* maps with str keys in the dict's own order (`to_bytes` keeps it),
  ints, floats (float64), bools, str, bin and nil;
* ext type 1, an ndarray; ext type 3, a numpy scalar (an ndarray of
  shape ());
* arrays over MAX_CHUNK_SIZE bytes split into flax's
  {"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": ...}} maps of flat chunks, joined again on read.

bfloat16 travels as its raw 16-bit patterns under the dtype name
"bfloat16": a torch.bfloat16 tensor is written so, and such a leaf reads
back as a torch.bfloat16 tensor (numpy has no bfloat16). Other leaves
read as numpy arrays over the read buffer, without a copy.

`write(f, tree)` streams the array bytes straight from each array's
buffer; `to_bytes` joins the same parts.
"""

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_BF16 = "bfloat16"


# ------------------------------------------------------------- packing


def _pack_int(n):
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError("int %d does not fit msgpack" % n)


def _pack_len(n, fix_code, fix_max, codes):
    """A length header: the fix form under `fix_max`, else the first of
    `codes` ((code, struct format, max)) that holds n."""
    if fix_code is not None and n <= fix_max:
        return bytes([fix_code | n])
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError("length %d does not fit msgpack" % n)


def _pack_str(s):
    b = s.encode("utf-8")
    return _pack_len(len(b), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                        (0xDA, ">H", 0xFFFF),
                                        (0xDB, ">I", 0xFFFFFFFF))) + b


def _bin_header(n):
    return _pack_len(n, None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                  (0xC6, ">I", 0xFFFFFFFF)))


def _array_header(n):
    return _pack_len(n, 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                   (0xDD, ">I", 0xFFFFFFFF)))


def _map_header(n):
    return _pack_len(n, 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                   (0xDF, ">I", 0xFFFFFFFF)))


def _ext_header(code, n):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _pack_len(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                  (0xC9, ">I", 0xFFFFFFFF))) + bytes([code])


def _raw(arr):
    """(shape, dtype name, a C-contiguous uint8 view of the bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), _BF16,
                    t.view(torch.int16).numpy().reshape(-1).view(np.uint8))
        arr = t.numpy()
    arr = np.asarray(arr)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    # not np.ascontiguousarray, which makes a 0-d array 1-d
    flat = np.ascontiguousarray(arr.reshape(-1))
    return arr.shape, arr.dtype.name, flat.view(np.uint8)


def _ndarray_parts(arr, code):
    shape, name, data = _raw(arr)
    head = (_array_header(3) + _array_header(len(shape))
            + b"".join(_pack_int(int(n)) for n in shape) + _pack_str(name)
            + _bin_header(data.nbytes))
    return [_ext_header(code, len(head) + data.nbytes) + head, data]


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes


def _flat(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").contiguous().reshape(-1)
    return np.ascontiguousarray(x).reshape(-1)


def _chunked(arr):
    """flax's `_chunk`: a map of the shape and the flat chunks."""
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = _flat(arr)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[lo:lo + size]
                       for i, lo in enumerate(range(0, n, size))}}


def _is_array(x):
    return isinstance(x, (np.ndarray, torch.Tensor))


def _parts(obj, out):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_pack_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_pack_str(obj))
    elif type(obj) is bytes:
        out += [_bin_header(len(obj)), obj]
    elif isinstance(obj, dict):
        out.append(_map_header(len(obj)))
        for key, val in obj.items():
            out.append(_pack_str(str(key)))
            if _is_array(val) and _nbytes(val) > MAX_CHUNK_SIZE:
                val = _chunked(val)
            _parts(val, out)
    elif _is_array(obj):
        out += _ndarray_parts(obj, _EXT_NDARRAY)
    elif isinstance(obj, np.generic):
        out += _ndarray_parts(np.asarray(obj), _EXT_NPSCALAR)
    else:
        raise TypeError("cannot serialize %r" % type(obj).__name__)


def parts(tree):
    """The serialized tree as a list of bytes-like parts (the array
    parts are views of the arrays' buffers)."""
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunked(tree)
    out = []
    _parts(tree, out)
    return out


def to_bytes(tree):
    """`flax.serialization.to_bytes(tree)` for a nested dict of arrays."""
    return b"".join(bytes(p) if not isinstance(p, bytes) else p
                    for p in parts(tree))


def write(f, tree):
    """Serialize `tree` into the binary file `f`, each array's bytes
    written from its buffer."""
    for part in parts(tree):
        f.write(part)


# ----------------------------------------------------------- unpacking


class _Reader(object):
    def __init__(self, data):
        self.mv = memoryview(data)
        self.pos = 0

    def take(self, n):
        lo = self.pos
        self.pos += n
        if self.pos > len(self.mv):
            raise ValueError("truncated msgpack data")
        return self.mv[lo:self.pos]

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self):
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if c in lens:
            n = self.unpack(lens[c])
            if c <= 0xC6:
                return self.take(n)
            if c <= 0xDB:
                return str(self.take(n), "utf-8")
            if c <= 0xDD:
                return [self.obj() for _ in range(n)]
            return self.map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            n = fixext[c]
        elif c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
        else:
            raise ValueError("msgpack type 0x%02x is not supported" % c)
        code = self.unpack("B")
        return _ext(code, self.take(n))

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _ndarray(data):
    shape, name, buf = _Reader(data).obj()
    shape = tuple(shape)
    if name == _BF16:
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError("msgpack ext type %d is not supported" % code)


def _unchunk(node):
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def msgpack_restore(data):
    """`flax.serialization.msgpack_restore(data)`: the nested dict of
    numpy arrays (torch.bfloat16 tensors for bfloat16 leaves), chunked
    arrays joined."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.mv):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)
