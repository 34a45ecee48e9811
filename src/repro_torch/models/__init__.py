"""PyTorch model of the port: staged decoder with early-exit heads."""
