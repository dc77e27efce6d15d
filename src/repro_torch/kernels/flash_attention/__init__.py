"""Flash attention: kernel K2 (``csrc/flash_attention.cu``), its plain
PyTorch version, the oracle and the model-layout adapter."""
