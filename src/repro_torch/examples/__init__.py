"""Runnable examples of the port, twins of the repository's ``examples/``.

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.distributed_jacobi
    python -m repro_torch.examples.serve_lm
    python -m repro_torch.examples.train_lm
    python -m repro_torch.examples.fault_tolerant_training

Each runs on the card unless ``--device cpu`` is given.
"""
