"""Command-line entry of the PyTorch port (``main/launch.py``)."""
