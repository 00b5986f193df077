"""The benchmark of the PyTorch and CUDA port (`tpusim_torch`): see
portbench/run.py and BENCHMARK.json."""
