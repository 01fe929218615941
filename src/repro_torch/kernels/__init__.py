"""The port's CUDA kernels, their plain PyTorch versions and the dispatch.

``csrc/*.cu`` hold the hand-written kernels for ``sm_90a`` (built and
bound by ``build``); ``pack``, ``take``, ``packed_matmul``,
``packed_matmul_batched``, ``kv_decode``, ``paged_attention``,
``unpack`` and ``convert`` (``convert`` and ``truncate``) are their
wrappers; ``ref`` the plain versions; ``ops``
sends each call to one or the other by the device of its tensors.
"""
