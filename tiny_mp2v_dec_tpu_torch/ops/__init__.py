"""Device operations: IDCT (K1), fused MC + reconstruction (K2, K3) and the
GOP-chunk transport (pairs to rows, K1's transform and the residual grid in
one kernel's three launches), each kernel beside its plain PyTorch
version."""
