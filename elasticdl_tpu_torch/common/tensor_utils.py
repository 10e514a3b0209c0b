"""ndarray dict (de)serialization for checkpoints, the port's copy of
elasticdl_tpu/common/tensor_utils.py: the same self-contained binary
layout, byte for byte,

    Tensor := name_len u16 | wire_dtype u8 | ndim u8 | name | dims i64[]
              | raw bytes (C order)
    Dict   := count u32 | Tensor... (sorted by name)

A value may be a numpy array or a torch tensor. A torch.bfloat16 tensor
is written as its 16-bit patterns under wire id 13, and id 13 reads back
as a torch.bfloat16 tensor; every other id reads as a numpy array.

Also `deduplicate_indexed_slices` / `merge_indexed_slices`, plain numpy.
"""

import struct

import numpy as np
import torch

from elasticdl_tpu_torch.common.dtypes import (
    BFLOAT16_WIRE_ID,
    BYTES_WIRE_ID,
    dtype_to_wire,
    wire_to_dtype,
)

_HEADER = struct.Struct("<HBB")  # name_len, wire_dtype, ndim
_DIM = struct.Struct("<q")


def _wire_array(array):
    """(wire id, numpy array of the bytes to write, shape)."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu()
        if array.dtype == torch.bfloat16:
            bits = array.contiguous().view(torch.int16).numpy()
            return BFLOAT16_WIRE_ID, bits, tuple(array.shape)
        array = array.numpy()
    array = np.asarray(array)
    shape = array.shape  # before ascontiguousarray, which promotes 0-d to 1-d
    array = np.ascontiguousarray(array)
    if array.dtype.kind == "U":  # unicode str arrays ride as utf-8 bytes
        array = np.char.encode(array, "utf-8")
    return dtype_to_wire(array.dtype), array, shape


def _ndarray_parts(array, name):
    """The serialized form of one array as [header bytes, raw bytes
    (a view of the array's memory, not a copy)]."""
    name_b = name.encode("utf-8")
    if len(name_b) > 0xFFFF:
        raise ValueError("tensor name too long")
    wire, array, shape = _wire_array(array)
    dims = list(shape)
    if wire == BYTES_WIRE_ID:
        if array.dtype.itemsize == 0:  # all-empty strings -> 1-byte slots
            array = array.astype("S1")
        dims.append(array.dtype.itemsize)  # trailing pseudo-dim: byte width
    header = [_HEADER.pack(len(name_b), wire, len(dims)), name_b]
    header += [_DIM.pack(d) for d in dims]
    return [b"".join(header), memoryview(array.reshape(-1).view(np.uint8))]


def serialize_ndarray(array, name=""):
    """Serialize one array or tensor (with optional name) to bytes."""
    return b"".join(_ndarray_parts(array, name))


def ndarray_dict_parts(d):
    """serialize_ndarray_dict(d) as a sequence of bytes-like parts, the
    arrays' raw bytes as views of their memory: a writer streams them
    to a file and a hash without building the whole payload."""
    yield struct.pack("<I", len(d))
    for name in sorted(d):
        yield from _ndarray_parts(d[name], name)


def deserialize_ndarray(buf, offset=0):
    """Inverse of serialize_ndarray. Returns (name, array, next_offset);
    the array is a read-only view of `buf`, or a torch.bfloat16 tensor
    for wire id 13."""
    name_len, wire, ndim = _HEADER.unpack_from(buf, offset)
    offset += _HEADER.size
    name = bytes(buf[offset:offset + name_len]).decode("utf-8")
    offset += name_len
    shape = []
    for _ in range(ndim):
        (d,) = _DIM.unpack_from(buf, offset)
        shape.append(d)
        offset += _DIM.size
    if wire == BYTES_WIRE_ID:
        itemsize = max(1, shape.pop())  # trailing pseudo-dim: byte width
        dtype = np.dtype("S%d" % itemsize)
    else:
        dtype = wire_to_dtype(wire)
    count = int(np.prod(shape)) if shape else 1
    array = np.frombuffer(buf, dtype=dtype, count=count,
                          offset=offset).reshape(tuple(shape))
    offset += count * dtype.itemsize
    if wire == BFLOAT16_WIRE_ID:
        array = torch.from_numpy(array.view(np.int16).copy()).view(
            torch.bfloat16)
    return name, array, offset


def serialize_ndarray_dict(d):
    """Serialize {name: array or tensor} to bytes (order-stable by
    name)."""
    return b"".join(ndarray_dict_parts(d))


def deserialize_ndarray_dict(buf):
    (n,) = struct.unpack_from("<I", buf, 0)
    offset = 4
    out = {}
    for _ in range(n):
        name, arr, offset = deserialize_ndarray(buf, offset)
        out[name] = arr
    return out


def deduplicate_indexed_slices(values, indices):
    """Sum-combine rows with duplicate indices: (summed, unique_indices)
    where summed[i] is the sum of the rows of `values` whose index is
    unique_indices[i]."""
    values = np.asarray(values)
    indices = np.asarray(indices)
    unique_ids, inverse = np.unique(indices, return_inverse=True)
    summed = np.zeros((unique_ids.shape[0],) + values.shape[1:], values.dtype)
    np.add.at(summed, inverse, values)
    return summed, unique_ids


def merge_indexed_slices(*slices_list):
    """Concatenate (values, ids) pairs; combine with
    deduplicate_indexed_slices."""
    values = np.concatenate([np.asarray(v) for v, _ in slices_list], axis=0)
    ids = np.concatenate([np.asarray(i) for _, i in slices_list], axis=0)
    return values, ids
