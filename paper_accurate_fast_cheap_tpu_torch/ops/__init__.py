"""The port's operators; the kernel wrappers build their CUDA sources at
first use.  Importing the package registers K1's forward as the operator
``pafc_torch::wkv6_fwd`` (``wkv6_cuda``), which a loaded exported program
calls."""
from paper_accurate_fast_cheap_tpu_torch.ops import wkv6_cuda  # noqa: F401
