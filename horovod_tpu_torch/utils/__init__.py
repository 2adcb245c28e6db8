"""Environment knobs and logging of the PyTorch port."""
