"""Stage primitives: delta, run-length encode, frame-of-reference bitpack.

JAX counterparts of the reference's standalone stage classes
(DeltaGPU, RunLengthEncodeGPU, BitPackGPU) and the fused cascaded block
primitives (reference src/CascadedKernels.hiph).

Import the submodules directly (``from tpucomp.ops import bitpack``); the
package namespace deliberately does not re-export functions whose names
collide with their modules.
"""

from tpucomp.ops import bitpack, delta, rle

__all__ = ["bitpack", "delta", "rle"]
