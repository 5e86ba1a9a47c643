"""PyTorch/CUDA port of the llmd-tpu serving engine for NVIDIA Hopper.

The package mirrors ``llmd_tpu``'s layout (``config``, ``models``, ``ops``,
``engine``, ``serve``) so each module has an obvious counterpart there, but
it imports nothing of it: every piece the port needs is its own copy. The
hot path is the flattened-token ("flat") step of a dense Llama-class model;
its two attention-side TPU kernels are hand-written CUDA kernels for
``sm_90a`` (``ops/csrc``), each with a plain PyTorch version beside it that
runs on CPU tensors.

Entry points (``LLMEngine``, ``ModelRunner``, ``python -m
llmd_tpu_torch.serve``) default to ``device="cuda"`` and raise when no GPU
is present; pass ``device="cpu"`` explicitly to run on the CPU.
"""
