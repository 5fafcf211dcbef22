"""PyTorch port of the loss-tolerant federated-learning system.

A package beside the JAX reference ``repro``: same configs, same round
semantics, same outputs for the same seed. Plain tensor code is
PyTorch; the reference's TPU kernels (the uplink megakernel, the
Gilbert–Elliott mask, the robust aggregation, the FEC repair, the TRA
aggregate, the q-FedAvg reweighting, the packet mask and flash
decoding) are CUDA C++ kernels for Hopper (``csrc/``). Beside the FL
system it serves the dense model family (``launch/serve.py``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
