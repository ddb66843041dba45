"""Library-surface examples on the torch path: twins of ``examples/``,
run as ``python -m repro_torch.examples.quickstart``."""
