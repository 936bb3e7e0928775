"""Tools of the PyTorch / CUDA port: the roofline analysis (roofline.py)."""
