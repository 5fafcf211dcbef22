"""PyTorch port of the loss-tolerant federated-learning system.

A package beside the JAX reference ``repro``: same configs, same round
semantics, same outputs for the same seed. Plain tensor code is
PyTorch; the reference's TPU kernels on the ported paths (the uplink
megakernel, the Gilbert–Elliott mask, the robust aggregation, the FEC
repair, the TRA aggregate, the q-FedAvg reweighting and the packet
mask) are CUDA C++ kernels for Hopper (``csrc/``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
