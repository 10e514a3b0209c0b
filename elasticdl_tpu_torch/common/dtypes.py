"""Dtype registry: numpy and torch dtypes <-> wire ids, the port's copy
of elasticdl_tpu/common/dtypes.py.

Wire ids are the stable small ints the tensor serialization
(`tensor_utils.py`) writes, so a checkpoint either package wrote reads in
the other. Id 13 is bfloat16. numpy has no bfloat16 and the port does
not use ml_dtypes, so id 13 travels as a `torch.bfloat16` tensor: its
raw 16-bit patterns are the bytes ml_dtypes writes.
"""

import numpy as np

# Stable wire ids. Never renumber: checkpoints depend on them.
_WIRE = [
    (1, np.dtype(np.float16)),
    (2, np.dtype(np.float32)),
    (3, np.dtype(np.float64)),
    (4, np.dtype(np.int8)),
    (5, np.dtype(np.int16)),
    (6, np.dtype(np.int32)),
    (7, np.dtype(np.int64)),
    (8, np.dtype(np.uint8)),
    (9, np.dtype(np.uint16)),
    (10, np.dtype(np.uint32)),
    (11, np.dtype(np.uint64)),
    (12, np.dtype(np.bool_)),
]

NP_DTYPE_TO_WIRE = {dt: wire_id for wire_id, dt in _WIRE}
WIRE_TO_NP_DTYPE = {wire_id: dt for wire_id, dt in _WIRE}

#: bfloat16, written as its raw 16-bit patterns (a torch.bfloat16 tensor)
BFLOAT16_WIRE_ID = 13
#: fixed-length bytes (numpy 'S<n>'); the itemsize rides in the
#: serialized shape (tensor_utils appends it as a trailing pseudo-dim)
BYTES_WIRE_ID = 14


def dtype_to_wire(dtype):
    dtype = np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
    if dtype.kind == "S":
        return BYTES_WIRE_ID
    try:
        return NP_DTYPE_TO_WIRE[dtype]
    except KeyError:
        raise ValueError("Unsupported dtype for serialization: %r" % (dtype,))


def wire_to_dtype(wire_id):
    """The numpy dtype of a wire id; id 13 reads as uint16 patterns
    (tensor_utils turns them into a torch.bfloat16 tensor)."""
    if wire_id == BFLOAT16_WIRE_ID:
        return np.dtype(np.uint16)
    try:
        return WIRE_TO_NP_DTYPE[wire_id]
    except KeyError:
        raise ValueError("Unknown wire dtype id: %r" % (wire_id,))

