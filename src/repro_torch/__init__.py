"""PyTorch port of the loss-tolerant federated-learning system.

A package beside the JAX reference ``repro``: same configs, same round
semantics, same outputs for the same seed. Plain tensor code is
PyTorch; the uplink megakernel is a CUDA C++ kernel for Hopper
(``csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
