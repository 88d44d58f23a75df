"""Search entry points over the PyTorch device path."""
