"""PyTorch/CUDA port of :mod:`repro` for an NVIDIA H100.

The package mirrors the reference layout (``core``, ``kernels``,
``models``, ``plan``, ``serve``, ...) so each module's counterpart is easy
to find.  Every Pallas kernel of the reference has a hand-written CUDA
counterpart under ``csrc/``, built at first use by
:mod:`repro_torch.kernels.build`; every kernel module also carries a
plain PyTorch version of the same function, which the wrapper runs for
tensors that lie on the CPU.

Entry points (``compile_plan``, ``AsyncAMCServeEngine`` and the kernel
wrappers) run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of carrying on on the CPU.

The package imports ``torch`` and numpy only: never ``jax`` and nothing
of the reference package.
"""

__all__ = ["resolve_device"]

from repro_torch.device import resolve_device
