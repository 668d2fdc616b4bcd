"""The benchmark of ``tiny_mp2v_dec_tpu_torch``, the PyTorch and CUDA port of
the decoder, on one NVIDIA GPU: ``python3 -m mp2v_bench.run --workload NAME
--seed N --seconds S --trace 0|1`` from the repository root.  The cells,
configurations and metrics are those of ``BENCHMARK.json``."""
