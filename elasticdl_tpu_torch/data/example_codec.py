"""Example codec: {feature_name: ndarray} <-> record payload bytes.

The port's copy of elasticdl_tpu/data/example_codec.py together with the
part of elasticdl_tpu/common/tensor_utils.py and common/dtypes.py it
uses, so payloads are byte-compatible with the JAX package's:

    dict   := count(u32) tensor*           (tensors sorted by name)
    tensor := name_len(u16) wire_dtype(u8) ndim(u8) name dims(i64)* bytes
"""

import struct

import numpy as np

# stable wire ids of the JAX package's dtype registry (never renumber)
_WIRE = {
    1: np.float16, 2: np.float32, 3: np.float64, 4: np.int8, 5: np.int16,
    6: np.int32, 7: np.int64, 8: np.uint8, 9: np.uint16, 10: np.uint32,
    11: np.uint64, 12: np.bool_,
}
#: fixed-length bytes ('S<n>'): the byte width rides as a trailing dim
BYTES_WIRE_ID = 14
_WIRE_TO_DTYPE = {w: np.dtype(t) for w, t in _WIRE.items()}
_DTYPE_TO_WIRE = {dt: w for w, dt in _WIRE_TO_DTYPE.items()}

_HEADER = struct.Struct("<HBB")  # name_len, wire_dtype, ndim
_DIM = struct.Struct("<q")


def _dtype_to_wire(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "S":
        return BYTES_WIRE_ID
    if dtype not in _DTYPE_TO_WIRE:
        raise ValueError("Unsupported dtype for serialization: %r" % (dtype,))
    return _DTYPE_TO_WIRE[dtype]


def _serialize(array, name):
    array = np.asarray(array)
    shape = array.shape  # before ascontiguousarray, which makes 0-d 1-d
    array = np.ascontiguousarray(array)
    name_b = name.encode("utf-8")
    if len(name_b) > 0xFFFF:
        raise ValueError("tensor name too long")
    if array.dtype.kind == "U":
        array = np.char.encode(array, "utf-8")
    wire = _dtype_to_wire(array.dtype)
    dims = list(shape)
    if wire == BYTES_WIRE_ID:
        if array.dtype.itemsize == 0:
            array = array.astype("S1")
        dims.append(array.dtype.itemsize)
    parts = [_HEADER.pack(len(name_b), wire, len(dims)), name_b]
    parts.extend(_DIM.pack(d) for d in dims)
    parts.append(array.tobytes())
    return b"".join(parts)


def _deserialize(buf, offset):
    name_len, wire, ndim = _HEADER.unpack_from(buf, offset)
    offset += _HEADER.size
    name = bytes(buf[offset:offset + name_len]).decode("utf-8")
    offset += name_len
    shape = []
    for _ in range(ndim):
        shape.append(_DIM.unpack_from(buf, offset)[0])
        offset += _DIM.size
    if wire == BYTES_WIRE_ID:
        dtype = np.dtype("S%d" % max(1, shape.pop()))
    elif wire in _WIRE_TO_DTYPE:
        dtype = _WIRE_TO_DTYPE[wire]
    else:
        raise ValueError("Unknown wire dtype id: %r" % (wire,))
    count = int(np.prod(shape)) if shape else 1
    array = np.frombuffer(buf, dtype=dtype, count=count,
                          offset=offset).reshape(tuple(shape))
    return name, array, offset + count * dtype.itemsize


def encode_example(features):
    """features: {name: ndarray-like} -> bytes."""
    parts = [struct.pack("<I", len(features))]
    for name in sorted(features):
        parts.append(_serialize(features[name], name))
    return b"".join(parts)


def decode_example(payload):
    """bytes -> {name: ndarray}."""
    (n,) = struct.unpack_from("<I", payload, 0)
    offset = 4
    out = {}
    for _ in range(n):
        name, arr, offset = _deserialize(payload, offset)
        out[name] = arr
    return out
