"""Device operations: IDCT (K1), fused MC + reconstruction (K2, K3) and the
GOP-chunk transport, each kernel beside its plain PyTorch version."""
