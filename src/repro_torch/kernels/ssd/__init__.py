"""Mamba2 SSD scan: kernel K4 (``csrc/ssd.cu``), its plain PyTorch
version, the oracle and the model-layout adapter."""
