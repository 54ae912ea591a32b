"""Core value types: element dtypes and per-chunk status codes.

JAX re-expression of the reference's C enums:
  - ``hipcompType_t``  (reference include/hipcomp.h:69-80)
  - ``hipcompStatus_t`` (reference include/hipcomp/shared_types.h:52-66)

Enum *values* match the reference exactly so that self-describing artifacts
(e.g. the dtype byte in a Cascaded partition header) are interchangeable.
"""

from __future__ import annotations

import enum

import jax.numpy as jnp
import numpy as np


class DataType(enum.IntEnum):
    """Element type of a chunk, as stored in format metadata.

    Values mirror HIPCOMP_TYPE_* (reference include/hipcomp.h:69-80).
    """

    CHAR = 0        # int8
    UCHAR = 1       # uint8
    SHORT = 2       # int16
    USHORT = 3      # uint16
    INT = 4         # int32
    UINT = 5        # uint32
    LONGLONG = 6    # int64
    ULONGLONG = 7   # uint64
    BITS = 0xFF     # single bits (used by BitComp only; unsupported here)


class Status(enum.IntEnum):
    """Per-chunk / per-call status codes.

    Values mirror hipcompStatus_t (reference include/hipcomp/shared_types.h).
    """

    SUCCESS = 0
    ERROR_INVALID_VALUE = 10
    ERROR_NOT_SUPPORTED = 11
    ERROR_CANNOT_DECOMPRESS = 12
    ERROR_BACKEND = 1000     # reference: hipcompErrorCudaError
    ERROR_INTERNAL = 10000


_SIGNED = {
    DataType.CHAR: jnp.int8,
    DataType.SHORT: jnp.int16,
    DataType.INT: jnp.int32,
    DataType.LONGLONG: jnp.int64,
    DataType.UCHAR: jnp.int8,
    DataType.USHORT: jnp.int16,
    DataType.UINT: jnp.int32,
    DataType.ULONGLONG: jnp.int64,
}

_UNSIGNED = {
    DataType.CHAR: jnp.uint8,
    DataType.UCHAR: jnp.uint8,
    DataType.SHORT: jnp.uint16,
    DataType.USHORT: jnp.uint16,
    DataType.INT: jnp.uint32,
    DataType.UINT: jnp.uint32,
    DataType.LONGLONG: jnp.uint64,
    DataType.ULONGLONG: jnp.uint64,
}

_WIDTH = {
    DataType.CHAR: 1,
    DataType.UCHAR: 1,
    DataType.SHORT: 2,
    DataType.USHORT: 2,
    DataType.INT: 4,
    DataType.UINT: 4,
    DataType.LONGLONG: 8,
    DataType.ULONGLONG: 8,
}

_FROM_NUMPY = {
    np.dtype(np.int8): DataType.CHAR,
    np.dtype(np.uint8): DataType.UCHAR,
    np.dtype(np.int16): DataType.SHORT,
    np.dtype(np.uint16): DataType.USHORT,
    np.dtype(np.int32): DataType.INT,
    np.dtype(np.uint32): DataType.UINT,
    np.dtype(np.int64): DataType.LONGLONG,
    np.dtype(np.uint64): DataType.ULONGLONG,
}


def width_of(dtype: DataType) -> int:
    """Element width in bytes."""
    return _WIDTH[DataType(dtype)]


def signed_jnp(dtype: DataType):
    """Signed jnp dtype of the same width (used for FOR min/max semantics,

    reference src/CascadedKernels.hiph:401-405)."""
    return _SIGNED[DataType(dtype)]


def unsigned_jnp(dtype: DataType):
    """Unsigned jnp dtype of the same width (used for wrapping arithmetic and

    bit shifts, reference src/CascadedKernels.hiph:489-496)."""
    return _UNSIGNED[DataType(dtype)]


def dtype_of_numpy(np_dtype) -> DataType:
    """Map a numpy dtype to the matching DataType."""
    return _FROM_NUMPY[np.dtype(np_dtype)]
