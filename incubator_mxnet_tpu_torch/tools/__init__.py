"""Command-line tools of the PyTorch port (`python -m
incubator_mxnet_tpu_torch.tools.launch`)."""
