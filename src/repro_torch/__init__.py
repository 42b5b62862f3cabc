"""PyTorch/CUDA port of the federated-unlearning system in ``repro``.

The package keeps ``repro``'s module paths and names, so every counterpart
sits at the same relative path.  It imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro``.  Entry points (``FLSimulator``,
``build_simulator``, ``FederatedSession``, ``run_scenario``) run on the CUDA
card unless the caller passes ``device="cpu"``; without a card they raise.
It runs the paper CNN's classification task and the generation task with
the NanoGPT, mamba and rwkv6 families, the paper's four unlearning
frameworks (SE, FE, FR, RR) and the forgetting verification of
``repro_torch.verify``.  On CUDA tensors the coded store, the encode,
the eq. 3 accumulate, the mamba scan and the rwkv6 WKV recurrence (forward
and backward) run through the hand-written Hopper kernels under
``repro_torch/kernels``.
"""
