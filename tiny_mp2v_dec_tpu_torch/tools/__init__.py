"""Measurement tools of the port, run on a CUDA card: ``tbench`` (device
timing), ``profile_mc_variants`` (K9/K10 against the gather formulations)
and ``perf_gate`` (hand kernels against their plain versions)."""
