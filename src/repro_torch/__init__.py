"""PyTorch + CUDA port of the packed register-file system.

A second package beside the JAX reference ``repro``, laid out module for
module like it. Operands rest in device memory as narrow Table 3 codes
packed into 32-bit words (groups of 32 codes); the hand-written CUDA
kernels under ``repro_torch.kernels`` expand them only in registers and
shared memory on the way to the math units.

Codes are carried in ``torch.int32`` tensors: the CPU build of torch has
no unsigned 32-bit right shift, so every ``>>`` is followed by a mask.
The CUDA kernels read the same buffers as ``uint32_t``.

Entry points (``serving.ServeEngine``, ``models.lm.LM``,
``launch.serve``) run on ``"cuda"`` unless the caller asks for
``device="cpu"``; with no card and no explicit CPU request they raise.
"""
