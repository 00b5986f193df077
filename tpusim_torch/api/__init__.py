"""Domain model, snapshots and podspec parsing of the PyTorch port."""
