"""Tools of the PyTorch port, run on the card with `python -m scenedino_torch.tools.<name>`."""
