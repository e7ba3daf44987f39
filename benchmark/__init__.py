"""The benchmark of the PyTorch and CUDA port (`rgbdseg_torch`) on one H100: see `run.py`."""
