"""PyTorch/CUDA port of the federated-unlearning system in ``repro``.

The package keeps ``repro``'s module paths and names, so every counterpart
sits at the same relative path.  It imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro``.  Entry points (``FLSimulator``,
``build_simulator``, ``FederatedSession``, ``run_scenario``) run on the CUDA
card unless the caller passes ``device="cpu"``; without a card they raise.
On CUDA tensors the coded store, the encode and the eq. 3 accumulate run
through the hand-written Hopper kernels under ``repro_torch/kernels``.
"""
