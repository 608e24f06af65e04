"""The benchmark of the PyTorch and CUDA port (``mvxnet_makise_tpu_torch``):
``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (``BENCHMARK.json`` names the
cells)."""
