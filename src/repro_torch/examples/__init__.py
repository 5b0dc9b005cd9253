"""Runnable examples, ``python -m repro_torch.examples.<name>``: the
reference's ``examples/`` drivers on the port."""
