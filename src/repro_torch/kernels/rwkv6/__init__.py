"""RWKV6 WKV scan: kernel K3 (``csrc/rwkv6.cu``), its plain PyTorch
version, the oracle and the model-layout adapter."""
