"""Training on the port (twin of ``repro.train``): optimizers, the train
step, the data pipeline, checkpoints, the fault-tolerant runner and
gradient compression. Training runs no kernel of the port: K8 and K7 are
forward-only, so a trained model attends and convolves by the plain
paths (``attn_impl="jnp"``, ``ssm_conv_impl="jnp"``), as the
reference's training does."""
