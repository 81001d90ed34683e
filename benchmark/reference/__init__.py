"""Plain PyTorch and NumPy reference of what the benchmark times: no import
of the system under test, no kernel, nothing the system made."""
